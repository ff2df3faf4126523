// C ABI for the fqzcomp5-tpu native engine (consumed via ctypes).
//
// Convention: every function returns >= 0 on success (typically bytes
// written) and -1 on failure.  Callers allocate output buffers; sizes
// are communicated through explicit bound helpers or known framing.

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef __GLIBC__
#include <malloc.h>
#endif

#include "rans.h"

// The codecs stage multi-MB buffers per call; glibc serves those from
// mmap by default and unmaps on free, so every call re-faults tens of
// MB of pages (measured: O0 decode 291 -> ~500 MB/s from this alone).
// Keep large chunks on the heap and don't trim them back to the kernel
// (reference analog: the fqzcomp5 binary reuses caller buffers and its
// TLS arena, utils.c:119-205, so it never pays these faults).
namespace {
struct MallocTuning {
    MallocTuning() {
#ifdef __GLIBC__
        mallopt(M_MMAP_THRESHOLD, 512 << 20);
        mallopt(M_TRIM_THRESHOLD, 512 << 20);
#endif
    }
} malloc_tuning_;
}  // namespace

extern "C" {

// ---- rANS Nx16 (framed; fqzcomp5 SEC payloads) -----------------------
int64_t fqz5_rans_compress(const uint8_t* in, uint32_t in_size, int order,
                           uint8_t* out, uint32_t out_cap) {
    int64_t n = fqz5::rans_compress_into(in, in_size, order, out, out_cap);
    return n < 0 ? -1 : n;
}

int64_t fqz5_rans_uncompress(const uint8_t* in, uint32_t in_size,
                             uint8_t* out, uint32_t out_cap,
                             uint32_t out_hint, int know_size) {
    return fqz5::rans_uncompress_into(in, in_size, out, out_cap, out_hint,
                                      know_size != 0);
}

}  // extern "C"

#include "rc.h"

extern "C" {

// Drive the range coder over raw (cum, freq, tot) triples — the test
// oracle for the batched device walk (ops/rc_jax.py).
int64_t fqz5_rc_encode_raw(const uint32_t* cum, const uint32_t* freq,
                           const uint32_t* tot, uint32_t n,
                           uint8_t* out, uint32_t out_cap) {
    if (out_cap < n * 5 + 16) return -1;
    fqz5::RangeCoder rc;
    rc.start_encode(out);
    for (uint32_t i = 0; i < n; i++)
        rc.encode(cum[i], freq[i], tot[i]);
    rc.finish_encode();
    return int64_t(rc.out_size());
}

int64_t fqz5_rc_decode_raw(const uint8_t* in, uint32_t in_size,
                           const uint32_t* cum, const uint32_t* freq,
                           const uint32_t* tot, uint32_t n,
                           uint32_t* dec_freq_out) {
    fqz5::RangeCoder rc;
    rc.start_decode(in, in + in_size);
    for (uint32_t i = 0; i < n; i++) {
        dec_freq_out[i] = rc.get_freq(tot[i]);
        rc.decode(cum[i], freq[i], tot[i]);
        if (rc.error()) return -1;
    }
    return int64_t(rc.in_consumed(in));
}

// Replay one AdaptiveModel over a symbol sequence, dumping the
// (cum, freq, tot) triple each encode would use — the oracle for the
// vectorised per-context model evolution (ops/fqz_model_jax.py).
int64_t fqz5_adaptive_replay(int max_sym, int step, const uint16_t* syms,
                             uint32_t n, uint32_t* cum_out,
                             uint32_t* freq_out, uint32_t* tot_out) {
    if (step == 16) {
        fqz5::AdaptiveModel<256, 16> m;
        m.init(max_sym);
        for (uint32_t i = 0; i < n; i++)
            m.encode_dump(syms[i], &cum_out[i], &freq_out[i],
                          &tot_out[i]);
        return n;
    } else if (step == 8) {
        fqz5::AdaptiveModel<256, 8> m;
        m.init(max_sym);
        for (uint32_t i = 0; i < n; i++)
            m.encode_dump(syms[i], &cum_out[i], &freq_out[i],
                          &tot_out[i]);
        return n;
    }
    return -1;
}

// Replay one TinyModel over an encode/update event sequence (upd[i]
// nonzero = adapt-only, the seq codec's both-strands shadow update) —
// the oracle for the vectorised tiny-model evolution
// (ops/fqz_model_jax.tiny_evolve).  Triples are dumped for every
// event; update events reuse encode_dump-style probing before the
// bump so callers can simply ignore them.
int64_t fqz5_tiny_replay(int nsym, const uint16_t* syms,
                         const uint8_t* upd, uint32_t n,
                         uint32_t* cum_out, uint32_t* freq_out,
                         uint32_t* tot_out) {
    if (nsym == 4) {
        fqz5::TinyModel<4> m;
        m.init();
        for (uint32_t i = 0; i < n; i++) {
            if (syms[i] >= 4) return -1;
            if (upd && upd[i]) {
                m.update(syms[i]);
                cum_out[i] = freq_out[i] = tot_out[i] = 0;
            } else {
                m.encode_dump(syms[i], &cum_out[i], &freq_out[i],
                              &tot_out[i]);
            }
        }
        return n;
    } else if (nsym == 2) {
        fqz5::TinyModel<2> m;
        m.init();
        for (uint32_t i = 0; i < n; i++) {
            if (syms[i] >= 2) return -1;
            if (upd && upd[i]) {
                m.update(syms[i]);
                cum_out[i] = freq_out[i] = tot_out[i] = 0;
            } else {
                m.encode_dump(syms[i], &cum_out[i], &freq_out[i],
                              &tot_out[i]);
            }
        }
        return n;
    }
    return -1;
}

}  // extern "C"

// Interleaved-state rANS (Nx16) codec, wire-compatible with the
// htscodecs rANS_static4x16pr format used by fqzcomp5.
//
// Format summary (reference: htscodecs/rANS_static4x16pr.c,
// rANS_static32x16pr.c, rANS_static16_int.h):
//  [order u8] [usize varint unless NOSZ] [transform meta] [payload]
// where payload is either CAT raw bytes or an Nx16 rANS stream
// (N = 4, or 32 when order bit X_32 is set), order-0 or order-1,
// preceded by a serialized frequency table.  Transforms: PACK (bit
// packing to <=16 symbols), RLE (runs/literals split), STRIPE
// (byte-transpose into N sub-streams, each recursively coded).
#ifndef FQZ5_RANS_H
#define FQZ5_RANS_H

#include <cstddef>
#include <cstdint>
#include <vector>

namespace fqz5 {

// Full framed codec (equivalent to rans_compress_to_4x16 /
// rans_uncompress_to_4x16).  Returns empty vector on failure.
std::vector<uint8_t> rans_compress(const uint8_t* in, uint32_t in_size,
                                   int order);
// Zero-copy variant: assembles the framed stream directly into `out`
// (no staging vector on the plain path).  Returns encoded size, -1 on
// failure, -2 when out_cap is too small.
int64_t rans_compress_into(const uint8_t* in, uint32_t in_size, int order,
                           uint8_t* out, size_t out_cap);
// out_hint: expected size when known (required for NOSZ payloads).
bool rans_uncompress(const uint8_t* in, uint32_t in_size,
                     std::vector<uint8_t>& out, uint32_t out_hint = 0,
                     bool know_size = false);
// Zero-copy variant: decodes directly into out (cap >= decoded size;
// PACK paths stage the packed bytes in the tail of out).  Returns
// decoded size or -1.
int64_t rans_uncompress_into(const uint8_t* in, uint32_t in_size,
                             uint8_t* out, uint32_t out_cap,
                             uint32_t out_hint = 0, bool know_size = false);

}  // namespace fqz5

#endif  // FQZ5_RANS_H

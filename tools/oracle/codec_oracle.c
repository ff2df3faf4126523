/* codec_oracle — dev-only byte-parity harness over the *reference*
 * htscodecs build (compiled from /root/reference into /tmp/oracle).
 *
 * This is test tooling, not part of the framework: it exposes the
 * reference codecs as stdin→stdout filters so the pytest suite can
 * assert our native/device codecs produce byte-identical streams.
 *
 * Commands (data on stdin, result on stdout):
 *   rans_enc <order>          rans_compress_4x16
 *   rans_dec                  rans_uncompress_4x16
 *   lzp_enc                   lzp16e.c:lzp
 *   lzp_dec                   [ulen u32][data] -> unlzp
 *   arith_enc <order>         arith_compress
 *   arith_dec                 arith_uncompress
 *   tok3_enc <level> <arith>  tok3_encode_names
 *   tok3_dec                  tok3_decode_names
 *   fqz_enc <strat>           [nrec u32][lens u32*n][flags u32*n][qual]
 *   fqz_dec                   fqz_decompress
 *
 * Build: tools/oracle/build.sh
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <stdint.h>

#include "htscodecs/rANS_static4x16.h"
#include "htscodecs/arith_dynamic.h"
#include "htscodecs/tokenise_name3.h"
#include "htscodecs/fqzcomp_qual.h"
#include "lzp16e.h"

static unsigned char *read_all(size_t *len) {
    size_t cap = 1 << 20, n = 0;
    unsigned char *buf = malloc(cap);
    for (;;) {
        if (n == cap) buf = realloc(buf, cap *= 2);
        size_t r = fread(buf + n, 1, cap - n, stdin);
        if (!r) break;
        n += r;
    }
    *len = n;
    return buf;
}

static void write_all(const void *p, size_t n) {
    fwrite(p, 1, n, stdout);
}

int main(int argc, char **argv) {
    if (argc < 2) return 2;
    size_t in_len;
    unsigned char *in = read_all(&in_len);
    const char *cmd = argv[1];

    if (!strcmp(cmd, "rans_enc")) {
        unsigned int osz;
        unsigned char *out = rans_compress_4x16(in, (unsigned)in_len, &osz,
                                                atoi(argv[2]));
        if (!out) return 1;
        write_all(out, osz);
    } else if (!strcmp(cmd, "rans_dec")) {
        unsigned int osz;
        unsigned char *out = rans_uncompress_4x16(in, (unsigned)in_len, &osz);
        if (!out) return 1;
        write_all(out, osz);
    } else if (!strcmp(cmd, "lzp_enc")) {
        unsigned char *out = malloc(in_len * 2 + 1024);
        int n = lzp(in, (int)in_len, out);
        if (n < 0) return 1;
        write_all(out, n);
    } else if (!strcmp(cmd, "lzp_dec")) {
        if (in_len < 4) return 1;
        uint32_t ulen;
        memcpy(&ulen, in, 4);
        unsigned char *out = malloc((size_t)ulen + 1024);
        int n = unlzp(in + 4, (int)(in_len - 4), out);
        if (n < 0) return 1;
        write_all(out, n);
    } else if (!strcmp(cmd, "arith_enc")) {
        unsigned int osz;
        unsigned char *out = arith_compress(in, (unsigned)in_len, &osz,
                                            atoi(argv[2]));
        if (!out) return 1;
        write_all(out, osz);
    } else if (!strcmp(cmd, "arith_dec")) {
        unsigned int osz;
        unsigned char *out = arith_uncompress(in, (unsigned)in_len, &osz);
        if (!out) return 1;
        write_all(out, osz);
    } else if (!strcmp(cmd, "tok3_enc")) {
        int osz;
        uint8_t *out = tok3_encode_names((char *)in, (int)in_len,
                                         atoi(argv[2]), atoi(argv[3]),
                                         &osz, NULL);
        if (!out) return 1;
        write_all(out, osz);
    } else if (!strcmp(cmd, "tok3_dec")) {
        uint32_t osz;
        uint8_t *out = tok3_decode_names(in, (uint32_t)in_len, &osz);
        if (!out) return 1;
        write_all(out, osz);
    } else if (!strcmp(cmd, "fqz_enc")) {
        if (in_len < 4) return 1;
        uint32_t nrec;
        memcpy(&nrec, in, 4);
        size_t hdr = 4 + (size_t)nrec * 8;
        if (in_len < hdr) return 1;
        fqz_slice s;
        s.num_records = (int)nrec;
        s.len = (uint32_t *)(in + 4);
        s.flags = (uint32_t *)(in + 4 + (size_t)nrec * 4);
        s.seq = NULL; /* matches host API's seq=None: disables seq ctx */
        size_t osz;
        char *out = fqz_compress(4, &s, (char *)(in + hdr), in_len - hdr,
                                 &osz, atoi(argv[2]), NULL);
        if (!out) return 1;
        write_all(out, osz);
    } else if (!strcmp(cmd, "fqz_dec")) {
        size_t osz;
        char *out = fqz_decompress((char *)in, in_len, &osz, NULL, 0, NULL);
        if (!out) return 1;
        write_all(out, osz);
    } else {
        fprintf(stderr, "unknown cmd %s\n", cmd);
        return 2;
    }
    return 0;
}

// Raw snappy block decompression (format_description.txt from
// google/snappy) -- used to load reference-built mapAD indexes (.tbw etc.,
// snap frame streams) at native speed; the Python implementation in
// index/mapad_native.py is the semantic reference and fallback.
#include <cstdint>
#include <cstring>

extern "C" {

// Returns the decompressed size, or -1 on malformed input / if the output
// does not fit in out_cap.
long long snappy_block_decompress(const uint8_t* in, long long in_len,
                                  uint8_t* out, long long out_cap) {
    long long pos = 0;
    // uvarint: declared uncompressed length
    uint64_t n = 0;
    int shift = 0;
    while (true) {
        if (pos >= in_len || shift > 63) return -1;
        uint8_t b = in[pos++];
        n |= (uint64_t)(b & 0x7F) << shift;
        if (!(b & 0x80)) break;
        shift += 7;
    }
    if ((long long)n > out_cap) return -1;
    long long opos = 0;
    while (pos < in_len) {
        uint8_t tag = in[pos++];
        unsigned kind = tag & 3;
        if (kind == 0) {  // literal
            long long len = tag >> 2;
            if (len >= 60) {
                int nb = (int)len - 59;
                if (pos + nb > in_len) return -1;
                len = 0;
                for (int i = 0; i < nb; i++) len |= (long long)in[pos + i] << (8 * i);
                pos += nb;
            }
            len += 1;
            if (pos + len > in_len || opos + len > (long long)n) return -1;
            memcpy(out + opos, in + pos, (size_t)len);
            pos += len;
            opos += len;
            continue;
        }
        long long len, off;
        if (kind == 1) {
            if (pos >= in_len) return -1;
            len = ((tag >> 2) & 0x7) + 4;
            off = ((long long)(tag >> 5) << 8) | in[pos++];
        } else if (kind == 2) {
            if (pos + 2 > in_len) return -1;
            len = (tag >> 2) + 1;
            off = (long long)in[pos] | ((long long)in[pos + 1] << 8);
            pos += 2;
        } else {
            if (pos + 4 > in_len) return -1;
            len = (tag >> 2) + 1;
            off = (long long)in[pos] | ((long long)in[pos + 1] << 8)
                | ((long long)in[pos + 2] << 16) | ((long long)in[pos + 3] << 24);
            pos += 4;
        }
        if (off <= 0 || off > opos || opos + len > (long long)n) return -1;
        const uint8_t* src = out + opos - off;
        if (off >= len) {
            memcpy(out + opos, src, (size_t)len);
            opos += len;
        } else {  // overlapping copy: byte-by-byte semantics
            for (long long i = 0; i < len; i++) out[opos + i] = src[i];
            opos += len;
        }
    }
    return opos == (long long)n ? (long long)n : -1;
}

}  // extern "C"

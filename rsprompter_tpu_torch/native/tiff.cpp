// TIFF strip and tile decompression for the port's image reader (data/tiff.py).
//
// The two byte-oriented codecs that libtiff runs under OpenCV's imread:
//
// - LZW (compression 5, tif_lzw.c): codes MSB-first, 9 bits after each
//   Clear (256), widening to 10, 11 and 12 bits one code early, when the
//   next free entry reaches 511, 1023 and 2047 (TIFF 6.0's "early change"),
//   EOI 257, first free entry 258. Each strip or tile starts a new code
//   stream. The old LSB-first form (a stream starting 0x00 0x01) is refused.
// - PackBits (compression 32773, tif_packbits.c): a header byte n; 0..127
//   copies n + 1 literal bytes, -1..-127 repeats the next byte 1 - n times,
//   -128 is a no-op.
//
// Each entry point decodes until ``cap`` bytes are out (a strip's or tile's
// size) and returns the count written; fewer than ``cap`` means the data
// ended first, and the caller raises. A malformed stream returns -1 with a
// message in ``err``. The input is untrusted: every read and write is
// bounds-checked. Plain C ABI for ctypes; no state is shared between calls.

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

constexpr int kClear = 256;
constexpr int kEoi = 257;
constexpr int kFirst = 258;
constexpr int kMaxCode = 4096;

int64_t failure(char* err, int errlen, const char* msg, long long code) {
    if (errlen > 0) snprintf(err, errlen, "%s%lld", msg, code);
    return -1;
}

}  // namespace

extern "C" {

int64_t tiff_lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap, char* err,
                        int errlen) {
    if (n >= 2 && src[0] == 0 && (src[1] & 1))
        return failure(err, errlen, "old-style (LSB-first) LZW is not decoded, first byte ", 0);
    static thread_local uint16_t prefix[kMaxCode];
    static thread_local uint8_t suffix[kMaxCode], first[kMaxCode];
    static thread_local uint16_t length[kMaxCode];
    for (int i = 0; i < 256; ++i) {
        prefix[i] = 0;
        suffix[i] = first[i] = (uint8_t)i;
        length[i] = 1;
    }
    int64_t out = 0, bitpos = 0, nbits_total = n * 8;
    int nbits = 9, next = kFirst, old = -1;
    while (out < cap) {
        if (bitpos + nbits > nbits_total) break;  // the data ended: the caller sees out < cap
        int code = 0;
        for (int b = 0; b < nbits; ++b, ++bitpos)
            code = (code << 1) | ((src[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
        if (code == kEoi) break;
        if (code == kClear) {
            nbits = 9;
            next = kFirst;
            old = -1;
            continue;
        }
        int entry;  // the string this code stands for, once the table holds it
        if (code < next && (code < 256 || code >= kFirst)) {
            if (old >= 0 && next < kMaxCode) {
                prefix[next] = (uint16_t)old;
                suffix[next] = first[code];
                first[next] = first[old];
                length[next] = (uint16_t)(length[old] + 1);
            }
            entry = code;
        } else if (code == next && old >= 0 && next < kMaxCode) {  // KwKwK
            prefix[next] = (uint16_t)old;
            suffix[next] = first[old];
            first[next] = first[old];
            length[next] = (uint16_t)(length[old] + 1);
            entry = next;
        } else {
            return failure(err, errlen, "corrupt LZW data: code ", code);
        }
        if (old >= 0 && next < kMaxCode) {
            ++next;
            if (next == 511 || next == 1023 || next == 2047) ++nbits;
        }
        old = code;
        int len = length[entry];
        int64_t keep = len < cap - out ? len : cap - out;  // a string past the end is cut
        int c = entry;
        for (int i = len - 1; i >= 0; --i) {
            if (i < keep) dst[out + i] = suffix[c];
            c = prefix[c];
        }
        out += keep;
    }
    return out;
}

int64_t tiff_packbits_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap,
                             char* err, int errlen) {
    (void)err;
    (void)errlen;
    int64_t in = 0, out = 0;
    while (out < cap && in < n) {
        int h = (int8_t)src[in++];
        if (h >= 0) {
            int64_t len = h + 1;
            if (len > n - in) len = n - in;
            if (len > cap - out) len = cap - out;
            memcpy(dst + out, src + in, (size_t)len);
            in += h + 1;
            out += len;
        } else if (h != -128) {
            if (in >= n) break;
            int64_t len = 1 - h;
            if (len > cap - out) len = cap - out;
            memset(dst + out, src[in++], (size_t)len);
            out += len;
        }
    }
    return out;
}

}  // extern "C"

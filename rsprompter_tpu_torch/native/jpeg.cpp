// Baseline JPEG decoder for the port's image reader (data/jpeg.py).
//
// Decodes as libjpeg-turbo does under OpenCV's cv2.imread(path,
// IMREAD_COLOR), so that the two give the same bytes: the ISLOW integer
// IDCT (jidctint.c), fancy upsampling (jdsample.c: h2v1, h1v2 and h2v2 with
// their alternating rounding biases; plain replication for other integral
// ratios and for planes two columns wide or less), the first sample row
// repeated above the image and the last below it (jdmainct.c), and the
// fixed-point YCbCr -> RGB tables of jdcolor.c. Grey is repeated into three
// channels. The output is BGR, or one grey plane (IMREAD_GRAYSCALE).
//
// Scope: baseline sequential Huffman (SOF0, and SOF1 at 8-bit precision);
// DQT with 8- and 16-bit entries, DHT, SOS (interleaved, or one component a
// scan), DRI and RST0-7; APPn and COM are skipped, apart from JFIF (APP0),
// Adobe's colour transform (APP14) and the EXIF orientation (APP1), which
// the caller applies as OpenCV does. 1 or 3 components, integral sampling
// ratios. Everything else (progressive, lossless, hierarchical and
// arithmetic-coded files, 12-bit samples, 4 components) is refused with the
// marker's name, and so are data that end or break before the last MCU,
// which libjpeg fills with grey after a warning. The input is untrusted (the
// server decodes request bodies): Huffman counts are checked before any
// table is filled, and frames of more than 2^30 pixels are refused, as
// OpenCV's imread refuses them.
//
// Plain C ABI for ctypes: each entry point returns 0, or 1 with a message
// in ``err``, or 2 with a message where the file is valid but of a form left
// out above. No state is shared between calls.

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct DecodeError {
    std::string msg;
    bool refused;  // a valid file of a form this decoder leaves out
};

std::string format(const char* fmt, va_list ap) {
    char buf[256];
    vsnprintf(buf, sizeof buf, fmt, ap);
    return buf;
}

// Data that are cut or corrupt: OpenCV's imread gives no image either.
[[noreturn]] void fail(const char* fmt, ...) {
    va_list ap;
    va_start(ap, fmt);
    std::string msg = format(fmt, ap);
    va_end(ap);
    throw DecodeError{msg, false};
}

// A valid file that libjpeg under OpenCV decodes and this decoder does not.
[[noreturn]] void refuse(const char* fmt, ...) {
    va_list ap;
    va_start(ap, fmt);
    std::string msg = format(fmt, ap);
    va_end(ap);
    throw DecodeError{msg, true};
}

const int kNatural[64] = {  // zigzag position -> natural (row-major) index
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

std::string marker_name(int m) {
    switch (m) {
        case 0xC2: return "SOF2 (progressive)";
        case 0xC3: return "SOF3 (lossless)";
        case 0xC5: return "SOF5 (differential sequential)";
        case 0xC6: return "SOF6 (differential progressive)";
        case 0xC7: return "SOF7 (differential lossless)";
        case 0xC8: return "JPG (reserved)";
        case 0xC9: return "SOF9 (arithmetic coding)";
        case 0xCA: return "SOF10 (arithmetic coding, progressive)";
        case 0xCB: return "SOF11 (arithmetic coding, lossless)";
        case 0xCC: return "DAC (arithmetic coding)";
        case 0xCD: return "SOF13 (arithmetic coding, differential)";
        case 0xCE: return "SOF14 (arithmetic coding, differential progressive)";
        case 0xCF: return "SOF15 (arithmetic coding, differential lossless)";
        case 0xDC: return "DNL";
        case 0xDE: return "DHP (hierarchical)";
        case 0xDF: return "EXP (hierarchical)";
        default: {
            char buf[8];
            snprintf(buf, sizeof buf, "FF%02X", m);
            return buf;
        }
    }
}

// --- Huffman tables (jdhuff.c jpeg_make_d_derived_tbl) ----------------------

constexpr int kLookBits = 9;
constexpr int64_t kMaxPixels = (int64_t)1 << 30;  // as imread refuses larger images

struct HuffTable {
    bool defined = false;
    uint8_t vals[256];
    int maxcode[17];    // the largest code of each length, -1 where none
    int valoffset[17];  // vals index = code + valoffset[length]
    uint16_t look[1 << kLookBits];  // (length << 8) | value; 0: a longer code

    // Refuses counts that are no prefix code before anything is written:
    // each code must fit its length and not be all ones (libjpeg's
    // JERR_BAD_HUFF_TABLE), which also keeps every ``look`` index below
    // 1 << kLookBits.
    void build(const uint8_t* counts, const uint8_t* v, int nvals, bool dc) {
        int code = 0;
        for (int l = 1; l <= 16; ++l) {
            code += counts[l - 1];
            if (code >= (1 << l)) fail("bad Huffman table (DHT): %d-bit codes overflow", l);
            code <<= 1;
        }
        if (dc)
            for (int i = 0; i < nvals; ++i)
                if (v[i] > 15) fail("bad Huffman table (DHT): DC symbol %d", v[i]);
        memcpy(vals, v, nvals);
        memset(look, 0, sizeof look);
        code = 0;
        for (int l = 1, k = 0; l <= 16; ++l) {
            valoffset[l] = k - code;
            for (int i = 0; i < counts[l - 1]; ++i, ++k, ++code)
                if (l <= kLookBits) {
                    int shift = kLookBits - l;
                    for (int j = 0; j < (1 << shift); ++j)
                        look[(code << shift) | j] = (uint16_t)((l << 8) | vals[k]);
                }
            maxcode[l] = counts[l - 1] ? code - 1 : -1;
            code <<= 1;
        }
        defined = true;
    }
};

// --- entropy-coded data (jdhuff.c fill_bit_buffer) --------------------------

struct BitReader {
    const uint8_t* p;
    const uint8_t* end;
    uint64_t acc = 0;    // bits, left-aligned
    int nbits = 0;       // bits in acc
    int filler = 0;      // of them, zero bits added past the data's end (at the tail)
    bool ended = false;  // a marker (p at its first FF) or the buffer's end was met

    void fill() {
        while (nbits <= 56) {
            unsigned byte = 0;
            if (!ended) {
                if (p >= end) {
                    ended = true;
                } else if (*p != 0xFF) {
                    byte = *p++;
                } else {
                    const uint8_t* q = p + 1;
                    while (q < end && *q == 0xFF) ++q;  // fill bytes before a marker
                    if (q < end && *q == 0) {
                        byte = 0xFF;  // FF 00 stands for a data byte FF
                        p = q + 1;
                    } else {
                        ended = true;
                    }
                }
            }
            if (ended) filler += 8;
            acc |= (uint64_t)byte << (56 - nbits);
            nbits += 8;
        }
    }
    void skip(int n) {
        if (n > nbits - filler)
            fail("truncated data: the entropy-coded segment ends before its last MCU");
        acc <<= n;
        nbits -= n;
    }
    int get(int n) {  // n in 1..16
        if (nbits < n) fill();
        int v = (int)(acc >> (64 - n));
        skip(n);
        return v;
    }
    int decode(const HuffTable& t) {
        if (nbits < 16) fill();
        unsigned e = t.look[acc >> (64 - kLookBits)];
        if (e) {
            skip(e >> 8);
            return e & 0xFF;
        }
        unsigned code16 = (unsigned)(acc >> 48);
        for (int l = kLookBits + 1; l <= 16; ++l) {
            int code = (int)(code16 >> (16 - l));
            if (code <= t.maxcode[l]) {
                skip(l);
                return t.vals[code + t.valoffset[l]];
            }
        }
        if (filler) fail("truncated data: the entropy-coded segment ends before its last MCU");
        fail("corrupt data: a bit string that no Huffman code matches");
    }
    // The position of the next marker after the bits taken: the buffered
    // bytes are dropped (the rest of a byte is padding), and any bytes left
    // before the marker are garbage.
    const uint8_t* marker_pos(bool strict) {
        const uint8_t* q = p;
        while (q + 1 < end && !(q[0] == 0xFF && q[1] != 0 && q[1] != 0xFF)) {
            if (strict && q[0] != 0xFF) fail("corrupt data: bytes before an expected RST marker");
            ++q;
        }
        if (q + 1 >= end) fail("truncated data: the file ends inside a scan");
        return q;
    }
    void restart(const uint8_t* at) {
        p = at;
        acc = 0;
        nbits = filler = 0;
        ended = false;
    }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// --- ISLOW inverse DCT (jidctint.c jpeg_idct_islow) -------------------------

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

struct RangeLimit {  // jdmaster.c prepare_range_limit_table, the post-IDCT half
    uint8_t t[1024];
    RangeLimit() {
        for (int v = 0; v < 1024; ++v)
            t[v] = v < 128 ? v + 128 : v < 512 ? 255 : v < 896 ? 0 : v - 896;
    }
    uint8_t operator()(int64_t x) const { return t[(int)x & 1023]; }
};

// One row or column of the IDCT's butterfly; ``in(i)`` the i-th input.
template <typename In>
inline void idct_1d(In in, int64_t out[8]) {
    int64_t z2 = in(2), z3 = in(6);
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = in(0);
    z3 = in(4);
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in(7);
    tmp1 = in(5);
    tmp2 = in(3);
    tmp3 = in(1);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    out[0] = tmp10 + tmp3;
    out[7] = tmp10 - tmp3;
    out[1] = tmp11 + tmp2;
    out[6] = tmp11 - tmp2;
    out[2] = tmp12 + tmp1;
    out[5] = tmp12 - tmp1;
    out[3] = tmp13 + tmp0;
    out[4] = tmp13 - tmp0;
}

// coef: dequantized coefficients, natural order; writes 8 x 8 samples
void idct_islow(const int32_t* coef, uint8_t* dst, int stride, const RangeLimit& limit) {
    int32_t ws[64];
    int64_t o[8];
    for (int c = 0; c < 8; ++c) {  // pass 1: columns
        const int32_t* col = coef + c;
        idct_1d([&](int i) { return (int64_t)col[8 * i]; }, o);
        for (int i = 0; i < 8; ++i) ws[8 * i + c] = (int32_t)descale(o[i], kConstBits - kPass1Bits);
    }
    for (int r = 0; r < 8; ++r) {  // pass 2: rows
        const int32_t* row = ws + 8 * r;
        idct_1d([&](int i) { return (int64_t)row[i]; }, o);
        uint8_t* out = dst + (size_t)r * stride;
        for (int i = 0; i < 8; ++i)
            out[i] = limit(descale(o[i], kConstBits + kPass1Bits + 3));
    }
}

// --- the decoder --------------------------------------------------------------

struct Component {
    int id, h, v, tq;
    int32_t q[64];     // latched at the component's first scan, natural order
    bool latched = false;
    int dc_table = 0, ac_table = 0, pred = 0;
    int dw = 0, dh = 0;        // downsampled width and height
    int stride = 0, rows = 0;  // the decoded plane, whole MCUs
    std::vector<uint8_t> plane;
};

struct Decoder {
    const uint8_t* data;
    const uint8_t* end;
    const uint8_t* p;
    int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
    int restart_interval = 0, orientation = 1;
    int expect_height = 0, expect_width = 0;  // the output's size, where one is given
    bool gray = false;  // one plane out (IMREAD_GRAYSCALE), not three
    bool frame = false, jfif = false, adobe = false;
    int adobe_transform = -1;
    uint16_t qt[4][64];
    bool qt_defined[4] = {false, false, false, false};
    HuffTable dc[4], ac[4];
    Component comp[3];
    RangeLimit limit;

    Decoder(const uint8_t* d, int64_t n) : data(d), end(d + n), p(d) {}

    int u8() {
        if (p >= end) fail("truncated data: the file ends inside a marker segment");
        return *p++;
    }
    int u16() {
        int hi = u8();
        return (hi << 8) | u8();
    }
    // the next marker's code; bytes between segments are refused
    int next_marker() {
        if (p + 1 >= end) fail("truncated data: no EOI marker");
        if (p[0] != 0xFF) fail("corrupt data: a marker was expected at byte %ld", (long)(p - data));
        while (p < end && *p == 0xFF) ++p;
        if (p >= end) fail("truncated data: no EOI marker");
        return *p++;
    }
    const uint8_t* segment(int& len) {
        len = u16() - 2;
        if (len < 0 || len > end - p) fail("truncated data: a marker segment runs past the file's end");
        const uint8_t* s = p;
        p += len;
        return s;
    }

    // headers up to the first SOS (``stop``), or the whole file
    void run(uint8_t* out, bool stop) {
        if (end - data < 2 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file (no SOI)");
        p = data + 2;
        for (;;) {
            int m = next_marker();
            int len = 0;
            if (m == 0xC0 || m == 0xC1) {
                const uint8_t* s = segment(len);
                sof(s, len, m);
            } else if (m == 0xC4) {
                const uint8_t* s = segment(len);
                dht(s, len);
            } else if (m == 0xDB) {
                const uint8_t* s = segment(len);
                dqt(s, len);
            } else if (m == 0xDD) {
                const uint8_t* s = segment(len);
                if (len != 2) fail("bad DRI length");
                restart_interval = (s[0] << 8) | s[1];
            } else if (m == 0xDA) {
                if (!frame) fail("SOS before SOF");
                if (stop) return;
                const uint8_t* s = segment(len);
                scan(s, len);
            } else if (m == 0xD9) {
                if (!frame) fail("EOI before SOF");
                if (stop) fail("no SOS marker");
                finish(out);
                return;
            } else if (m == 0xE0) {
                const uint8_t* s = segment(len);
                if (len >= 5 && !memcmp(s, "JFIF\0", 5)) jfif = true;
            } else if (m == 0xE1) {
                const uint8_t* s = segment(len);
                exif(s, len);
            } else if (m == 0xEE) {
                const uint8_t* s = segment(len);
                if (len >= 12 && !memcmp(s, "Adobe", 5)) {
                    adobe = true;
                    adobe_transform = s[11];
                }
            } else if ((m >= 0xE2 && m <= 0xEF) || m == 0xFE) {  // other APPn, COM
                segment(len);
            } else if (m >= 0xD0 && m <= 0xD7) {
                fail("RST%d marker outside a scan", m - 0xD0);
            } else if (m == 0xD8) {
                fail("a second SOI marker");
            } else if ((m >= 0xC1 && m <= 0xCF) || (m >= 0xDC && m <= 0xDF)) {  // forms left out
                refuse("unsupported marker %s: only baseline sequential Huffman JPEG is decoded",
                       marker_name(m).c_str());
            } else {
                fail("unsupported marker %s: only baseline sequential Huffman JPEG is decoded",
                     marker_name(m).c_str());
            }
        }
    }

    void sof(const uint8_t* s, int len, int m) {
        if (frame) fail("a second SOF marker");
        if (len < 6) fail("bad SOF length");
        int precision = s[0];
        height = (s[1] << 8) | s[2];
        width = (s[3] << 8) | s[4];
        ncomp = s[5];
        if (precision != 8)
            refuse("SOF%d at %d-bit precision: only 8-bit samples are decoded", m - 0xC0,
                   precision);
        if (height == 0) fail("image height 0 (height given by a DNL marker)");
        if (width == 0) fail("image width 0");
        if ((int64_t)width * height > kMaxPixels)
            fail("image of %dx%d pixels: more than 2^30, OpenCV's CV_IO_MAX_IMAGE_PIXELS", width,
                 height);
        if (expect_height && (height != expect_height || width != expect_width))
            fail("the output's size is not the image's");
        if (ncomp == 4) refuse("4 components (CMYK or YCCK)");
        if (ncomp != 1 && ncomp != 3) fail("%d components: only 1 or 3 are decoded", ncomp);
        if (len != 6 + 3 * ncomp) fail("bad SOF length");
        hmax = vmax = 1;
        for (int i = 0; i < ncomp; ++i) {
            Component& c = comp[i];
            c.id = s[6 + 3 * i];
            c.h = s[7 + 3 * i] >> 4;
            c.v = s[7 + 3 * i] & 15;
            c.tq = s[8 + 3 * i];
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail("bad sampling factors %dx%d", c.h, c.v);
            if (c.tq > 3) fail("bad quantization table index %d", c.tq);
            hmax = c.h > hmax ? c.h : hmax;
            vmax = c.v > vmax ? c.v : vmax;
        }
        mcux = (width + 8 * hmax - 1) / (8 * hmax);
        mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        for (int i = 0; i < ncomp; ++i) {
            Component& c = comp[i];
            if (hmax % c.h || vmax % c.v)
                fail("sampling factors %dx%d against %dx%d: not an integral ratio", c.h, c.v, hmax,
                     vmax);
            c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
            c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
            c.stride = mcux * c.h * 8;
            c.rows = mcuy * c.v * 8;
        }
        frame = true;
    }

    void dht(const uint8_t* s, int len) {
        int i = 0;
        while (i < len) {
            if (i + 17 > len) fail("bad DHT length");
            int tc = s[i] >> 4, th = s[i] & 15;
            if (tc > 1 || th > 3) fail("bad DHT table class %d or index %d", tc, th);
            int n = 0;
            for (int l = 0; l < 16; ++l) n += s[i + 1 + l];
            if (n > 256 || i + 17 + n > len) fail("bad DHT length");
            (tc ? ac : dc)[th].build(s + i + 1, s + i + 17, n, tc == 0);
            i += 17 + n;
        }
    }

    void dqt(const uint8_t* s, int len) {
        int i = 0;
        while (i < len) {
            int pq = s[i] >> 4, tq = s[i] & 15;
            if (pq > 1 || tq > 3) fail("bad DQT precision %d or index %d", pq, tq);
            int size = pq ? 128 : 64;
            if (i + 1 + size > len) fail("bad DQT length");
            for (int k = 0; k < 64; ++k)
                qt[tq][kNatural[k]] = pq ? (uint16_t)((s[i + 1 + 2 * k] << 8) | s[i + 2 + 2 * k])
                                         : s[i + 1 + k];
            qt_defined[tq] = true;
            i += 1 + size;
        }
    }

    // the EXIF orientation (tag 0x0112 of IFD0), as OpenCV's ExifReader reads it
    void exif(const uint8_t* s, int len) {
        if (len < 14 || memcmp(s, "Exif\0\0", 6)) return;
        const uint8_t* t = s + 6;
        int n = len - 6;
        bool le = t[0] == 'I' && t[1] == 'I';
        if (!le && !(t[0] == 'M' && t[1] == 'M')) return;
        auto r16 = [&](int o) { return le ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1]; };
        auto r32 = [&](int o) {
            return le ? (uint32_t)(t[o] | (t[o + 1] << 8) | (t[o + 2] << 16) | ((uint32_t)t[o + 3] << 24))
                      : (uint32_t)(((uint32_t)t[o] << 24) | (t[o + 1] << 16) | (t[o + 2] << 8) | t[o + 3]);
        };
        int64_t ifd = r32(4);
        if (ifd + 2 > n) return;
        int count = r16((int)ifd);
        for (int k = 0; k < count; ++k) {
            int64_t e = ifd + 2 + 12 * k;
            if (e + 12 > n) return;
            if (r16((int)e) == 0x0112) {
                int v = r16((int)e + 8);
                orientation = v >= 1 && v <= 8 ? v : 1;
                return;
            }
        }
    }

    void scan(const uint8_t* s, int len) {
        if (len < 1) fail("bad SOS length");
        int ns = s[0];
        if (ns < 1 || ns > ncomp || len != 4 + 2 * ns) fail("bad SOS length or component count");
        Component* sc[3];
        int blocks_in_mcu = 0;
        for (int i = 0; i < ns; ++i) {
            int id = s[1 + 2 * i], k = 0;
            while (k < ncomp && comp[k].id != id) ++k;
            if (k == ncomp) fail("SOS names component %d, which SOF does not", id);
            Component& c = comp[k];
            c.dc_table = s[2 + 2 * i] >> 4;
            c.ac_table = s[2 + 2 * i] & 15;
            if (c.dc_table > 3 || c.ac_table > 3 || !dc[c.dc_table].defined || !ac[c.ac_table].defined)
                fail("SOS uses a Huffman table that no DHT defined");
            if (!c.latched) {  // jdinput.c latch_quant_tables
                if (!qt_defined[c.tq]) fail("quantization table %d is not defined", c.tq);
                for (int j = 0; j < 64; ++j) c.q[j] = qt[c.tq][j];
                c.latched = true;
                c.plane.assign((size_t)c.stride * c.rows, 0);
            }
            c.pred = 0;
            sc[i] = &c;
            blocks_in_mcu += c.h * c.v;
        }
        int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ah = s[3 + 2 * ns] >> 4, al = s[3 + 2 * ns] & 15;
        if (ss != 0 || se != 63 || ah != 0 || al != 0)
            fail("SOS with spectral selection %d..%d, approximation %d/%d: not a sequential scan", ss,
                 se, ah, al);
        if (ns > 1 && blocks_in_mcu > 10) fail("%d blocks in an MCU (at most 10)", blocks_in_mcu);

        // one component alone: an MCU is one block, over the component's own size
        int mx = ns == 1 ? (sc[0]->dw + 7) / 8 : mcux;
        int my = ns == 1 ? (sc[0]->dh + 7) / 8 : mcuy;
        int64_t total = (int64_t)mx * my;
        BitReader br{p, end};
        int32_t coef[64];
        int next_rst = 0;
        for (int64_t m = 0; m < total; ++m) {
            if (restart_interval && m > 0 && m % restart_interval == 0) {
                const uint8_t* at = br.marker_pos(true);
                if (at[1] != 0xD0 + next_rst)
                    fail("expected RST%d, found marker %s", next_rst, marker_name(at[1]).c_str());
                br.restart(at + 2);
                next_rst = (next_rst + 1) & 7;
                for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
            }
            int bx0 = (int)(m % mx), by0 = (int)(m / mx);
            for (int i = 0; i < ns; ++i) {
                Component& c = *sc[i];
                int bh = ns == 1 ? 1 : c.h, bv = ns == 1 ? 1 : c.v;
                for (int y = 0; y < bv; ++y)
                    for (int x = 0; x < bh; ++x) {
                        block(br, c, coef);
                        size_t row = (size_t)(by0 * bv + y) * 8, col = (size_t)(bx0 * bh + x) * 8;
                        idct_islow(coef, c.plane.data() + row * c.stride + col, c.stride, limit);
                    }
            }
        }
        p = br.marker_pos(false);
    }

    void block(BitReader& br, Component& c, int32_t* coef) {
        memset(coef, 0, 64 * sizeof(int32_t));
        int s = br.decode(dc[c.dc_table]);
        int diff = s ? extend(br.get(s), s) : 0;
        c.pred += diff;
        coef[0] = (int16_t)c.pred * c.q[0];  // JCOEF is 16-bit
        for (int k = 1; k < 64;) {
            int rs = br.decode(ac[c.ac_table]);
            int r = rs >> 4;
            s = rs & 15;
            if (s) {
                k += r;
                if (k > 63) fail("corrupt data: a run of coefficients past the block's end");
                coef[kNatural[k]] = (int16_t)extend(br.get(s), s) * c.q[kNatural[k]];
                ++k;
            } else {
                if (r != 15) break;
                k += 16;
            }
        }
    }

    // --- upsampling (jdsample.c) and colour conversion (jdcolor.c) -----------

    // component ``c`` at full size: width x height samples
    void upsample(const Component& c, std::vector<uint8_t>& out) const {
        int rh = hmax / c.h, rv = vmax / c.v;
        out.resize((size_t)width * height);
        auto in_row = [&](int y) {
            y = y < 0 ? 0 : y >= c.dh ? c.dh - 1 : y;  // the edge rows repeated
            return c.plane.data() + (size_t)y * c.stride;
        };
        std::vector<int> line(2 * (size_t)c.dw + 2);
        for (int y = 0; y < height; ++y) {
            uint8_t* o = out.data() + (size_t)y * width;
            if (rh == 1 && rv == 1) {
                memcpy(o, in_row(y), width);
            } else if (rh == 2 && rv == 1 && c.dw > 2) {  // h2v1_fancy_upsample
                const uint8_t* in = in_row(y);
                int n = c.dw;
                line[0] = in[0];
                line[1] = (in[0] * 3 + in[1] + 2) >> 2;
                for (int i = 1; i < n - 1; ++i) {
                    line[2 * i] = (in[i] * 3 + in[i - 1] + 1) >> 2;
                    line[2 * i + 1] = (in[i] * 3 + in[i + 1] + 2) >> 2;
                }
                line[2 * n - 2] = (in[n - 1] * 3 + in[n - 2] + 1) >> 2;
                line[2 * n - 1] = in[n - 1];
                for (int x = 0; x < width; ++x) o[x] = (uint8_t)line[x];
            } else if (rh == 1 && rv == 2) {  // h1v2_fancy_upsample
                int iy = y / 2, below = y & 1;
                const uint8_t* near = in_row(iy);
                const uint8_t* far = in_row(below ? iy + 1 : iy - 1);
                int bias = below ? 2 : 1;
                for (int x = 0; x < width; ++x) o[x] = (uint8_t)((near[x] * 3 + far[x] + bias) >> 2);
            } else if (rh == 2 && rv == 2 && c.dw > 2) {  // h2v2_fancy_upsample
                int iy = y / 2, below = y & 1;
                const uint8_t* near = in_row(iy);
                const uint8_t* far = in_row(below ? iy + 1 : iy - 1);
                int n = c.dw;
                auto sum = [&](int i) { return near[i] * 3 + far[i]; };
                line[0] = (sum(0) * 4 + 8) >> 4;
                line[1] = (sum(0) * 3 + sum(1) + 7) >> 4;
                for (int i = 1; i < n - 1; ++i) {
                    line[2 * i] = (sum(i) * 3 + sum(i - 1) + 8) >> 4;
                    line[2 * i + 1] = (sum(i) * 3 + sum(i + 1) + 7) >> 4;
                }
                line[2 * n - 2] = (sum(n - 1) * 3 + sum(n - 2) + 8) >> 4;
                line[2 * n - 1] = (sum(n - 1) * 4 + 7) >> 4;
                for (int x = 0; x < width; ++x) o[x] = (uint8_t)line[x];
            } else {  // int_upsample, h2v1_upsample, h2v2_upsample: replication
                const uint8_t* in = c.plane.data() + (size_t)(y / rv) * c.stride;
                for (int x = 0; x < width; ++x) o[x] = in[x / rh];
            }
        }
    }

    void finish(uint8_t* out) {
        for (int i = 0; i < ncomp; ++i)
            if (!comp[i].latched) fail("component %d is in no scan", comp[i].id);
        size_t n = (size_t)width * height;
        // jdapimin.c default_decompress_parms: RGB where Adobe's transform
        // says 0 or the component ids spell R, G, B (and no JFIF marker)
        bool rgb = ncomp == 3 && !jfif &&
                   ((adobe && adobe_transform == 0) ||
                    (!adobe && comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B'));
        if (ncomp == 1 || (gray && !rgb)) {
            // grey out of YCbCr is the Y plane alone (jdcolor.c grayscale_convert)
            std::vector<uint8_t> y;
            upsample(comp[0], y);
            if (gray) {
                memcpy(out, y.data(), n);
                return;
            }
            for (size_t i = 0; i < n; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
            return;
        }
        std::vector<uint8_t> a, b, c;
        upsample(comp[0], a);
        upsample(comp[1], b);
        upsample(comp[2], c);
        if (rgb && gray) {
            // jdcolor.c rgb_gray_convert: the rgb_ycc tables' Y row, SCALEBITS 16
            auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
            const int64_t half = (int64_t)1 << 15;
            for (size_t i = 0; i < n; ++i)
                out[i] = (uint8_t)((fix(0.29900) * a[i] + fix(0.58700) * b[i] +
                                    fix(0.11400) * c[i] + half) >> 16);
            return;
        }
        if (rgb) {
            for (size_t i = 0; i < n; ++i) {
                out[3 * i] = c[i];
                out[3 * i + 1] = b[i];
                out[3 * i + 2] = a[i];
            }
            return;
        }
        // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
        const int64_t half = (int64_t)1 << 15;
        auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
        int cr_r[256], cb_b[256];
        int64_t cr_g[256], cb_g[256];
        for (int i = 0; i < 256; ++i) {
            int64_t x = i - 128;
            cr_r[i] = (int)((fix(1.40200) * x + half) >> 16);
            cb_b[i] = (int)((fix(1.77200) * x + half) >> 16);
            cr_g[i] = -fix(0.71414) * x;
            cb_g[i] = -fix(0.34414) * x + half;
        }
        auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
        for (size_t i = 0; i < n; ++i) {
            int y = a[i], cb = b[i], cr = c[i];
            out[3 * i] = clamp(y + cb_b[cb]);
            out[3 * i + 1] = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
            out[3 * i + 2] = clamp(y + cr_r[cr]);
        }
    }
};

int report(const DecodeError& e, char* err, int errlen) {
    if (errlen > 0) snprintf(err, errlen, "%s", e.msg.c_str());
    return e.refused ? 2 : 1;
}

}  // namespace

extern "C" {

// Reads the headers up to the first SOS: the image's height, width and EXIF
// orientation (1-8).
int jpeg_header(const uint8_t* data, int64_t n, int* height, int* width, int* orientation,
                char* err, int errlen) {
    try {
        Decoder d(data, n);
        d.run(nullptr, true);
        *height = d.height;
        *width = d.width;
        *orientation = d.orientation;
        return 0;
    } catch (const DecodeError& e) {
        return report(e, err, errlen);
    }
}

// Decodes the whole file into ``out``: height x width x 3 bytes, BGR, before
// the EXIF orientation is applied. ``height`` and ``width`` are
// ``jpeg_header``'s.
int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int height, int width, char* err,
                int errlen) {
    try {
        Decoder d(data, n);
        d.expect_height = height;
        d.expect_width = width;
        d.run(out, false);
        return 0;
    } catch (const DecodeError& e) {
        return report(e, err, errlen);
    }
}

// As jpeg_decode, into height x width bytes of grey: OpenCV's
// IMREAD_GRAYSCALE, libjpeg's JCS_GRAYSCALE output (the Y plane of a YCbCr
// file, jdcolor.c's weights for an RGB one).
int jpeg_decode_gray(const uint8_t* data, int64_t n, uint8_t* out, int height, int width,
                     char* err, int errlen) {
    try {
        Decoder d(data, n);
        d.expect_height = height;
        d.expect_width = width;
        d.gray = true;
        d.run(out, false);
        return 0;
    } catch (const DecodeError& e) {
        return report(e, err, errlen);
    }
}

}  // extern "C"

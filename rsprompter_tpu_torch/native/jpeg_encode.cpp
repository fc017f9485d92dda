// Baseline JPEG encoder for the port's image writer (data/jpeg.py).
//
// Encodes as libjpeg-turbo does under OpenCV's cv2.imencode('.jpg', img,
// [IMWRITE_JPEG_QUALITY, q]), so that the two give the same bytes: the
// quality scaling of jcparam.c with baseline forced (table entries clamped
// to 1..255), the fixed-point RGB -> YCbCr tables of jccolor.c, 4:2:0
// sampling by h2v2_downsample (jcsample.c: the 1, 2, 1, 2 rounding bias,
// the right edge replicated to whole blocks), the last row repeated down to
// whole MCUs (jcprepct.c), the ISLOW forward DCT (jfdctint.c), libjpeg-turbo's
// reciprocal quantiser (jcdctmgr.c), dummy blocks past the image carrying
// the previous block's DC (jccoefct.c), the standard Huffman tables without
// optimisation (jchuff.c), and the markers jcmarker.c writes: SOI, JFIF
// 1.01 APP0, one DQT a table, SOF0, one DHT a table, SOS, EOI.
//
// Input: 3-channel BGR uint8, row-major, quality 1..100. Plain C ABI for
// ctypes: jpeg_encode returns the encoded size; where it exceeds ``cap``
// nothing is written and the caller calls again with a buffer that large.
// It returns -1 with a message in ``err`` for an input it refuses.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

const int kNatural[64] = {  // zigzag position -> natural (row-major) index
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// JPEG Annex K tables, natural order (jcparam.c)
const int kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Huffman specs: counts of codes of length 1..16, then the symbols
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffTable {
    const uint8_t* bits;
    const uint8_t* vals;
    int nvals;
    unsigned code[256] = {};
    int size[256] = {};

    HuffTable(const uint8_t* b, const uint8_t* v, int n) : bits(b), vals(v), nvals(n) {
        // canonical codes, as jpeg_make_c_derived_tbl assigns them
        unsigned c = 0;
        int p = 0;
        for (int len = 1; len <= 16; len++) {
            for (int i = 0; i < bits[len - 1]; i++, p++) {
                code[vals[p]] = c++;
                size[vals[p]] = len;
            }
            c <<= 1;
        }
    }
};

// Quantisation divisors of jcdctmgr.c for a 16-bit DCTELEM: the ISLOW
// output carries a factor 8, so the divisor is the table entry << 3.
struct Divisor {
    uint32_t recip, corr, shift;
};

Divisor reciprocal(uint32_t divisor) {
    int b = 0;
    while ((divisor >> (b + 1)) != 0) b++;  // flss(divisor) - 1
    uint32_t r = 16 + b;
    uint32_t fq = (1u << r) / divisor, fr = (1u << r) % divisor;
    uint32_t c = divisor / 2;
    if (fr == 0) {
        fq >>= 1;
        r--;
    } else if (fr <= divisor / 2) {
        c++;
    } else {
        fq++;
    }
    return {fq & 0xFFFF, c, r - 16};
}

int scaled_quality(int quality) {  // jpeg_quality_scaling
    return quality < 50 ? 5000 / quality : 200 - quality * 2;
}

void quant_table(const int* basic, int scale, int* out) {  // jpeg_add_quant_table
    for (int i = 0; i < 64; i++) {
        long t = (static_cast<long>(basic[i]) * scale + 50L) / 100L;
        out[i] = static_cast<int>(std::min(std::max(t, 1L), 255L));  // baseline forced
    }
}

// jfdctint.c: the LL&M ISLOW forward DCT in place on 64 level-shifted samples
const int kConstBits = 13, kPass1Bits = 2;
inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

void fdct_islow(int32_t* d) {
    const int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;
    for (int pass = 0; pass < 2; pass++) {
        const int step = pass == 0 ? 1 : 8;   // along the row, then down the column
        const int next = pass == 0 ? 8 : 1;
        const int sh = pass == 0 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
        for (int k = 0; k < 8; k++) {
            int32_t* p = d + k * next;
            int32_t t0 = p[0] + p[7 * step], t7 = p[0] - p[7 * step];
            int32_t t1 = p[step] + p[6 * step], t6 = p[step] - p[6 * step];
            int32_t t2 = p[2 * step] + p[5 * step], t5 = p[2 * step] - p[5 * step];
            int32_t t3 = p[3 * step] + p[4 * step], t4 = p[3 * step] - p[4 * step];
            int32_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
            if (pass == 0) {
                p[0] = (t10 + t11) * (1 << kPass1Bits);
                p[4 * step] = (t10 - t11) * (1 << kPass1Bits);
            } else {
                p[0] = descale(t10 + t11, kPass1Bits);
                p[4 * step] = descale(t10 - t11, kPass1Bits);
            }
            int32_t z1 = (t12 + t13) * F0541;
            p[2 * step] = descale(z1 + t13 * F0765, sh);
            p[6 * step] = descale(z1 + t12 * -F1847, sh);
            z1 = t4 + t7;
            int32_t z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
            int32_t z5 = (z3 + z4) * F1175;
            t4 *= F0298;
            t5 *= F2053;
            t6 *= F3072;
            t7 *= F1501;
            z1 *= -F0899;
            z2 *= -F2562;
            z3 *= -F1961;
            z4 *= -F0390;
            z3 += z5;
            z4 += z5;
            p[7 * step] = descale(t4 + z1 + z3, sh);
            p[5 * step] = descale(t5 + z2 + z4, sh);
            p[3 * step] = descale(t6 + z2 + z3, sh);
            p[step] = descale(t7 + z1 + z4, sh);
        }
    }
}

struct BitWriter {
    std::vector<uint8_t>& out;
    uint32_t acc = 0;
    int n = 0;

    void put(uint32_t bits, int size) {  // size <= 16
        acc = (acc << size) | (bits & ((1u << size) - 1));
        n += size;
        while (n >= 8) {
            uint8_t byte = static_cast<uint8_t>(acc >> (n - 8));
            out.push_back(byte);
            if (byte == 0xFF) out.push_back(0);  // byte stuffing
            n -= 8;
        }
        acc &= (1u << n) - 1;
    }
    void flush() {  // pad the last byte with ones (jchuff.c flush_bits)
        if (n) put(0x7F, 8 - n);
    }
};

// A plane of one component, ``rows`` x ``cols`` samples.
struct Plane {
    int rows, cols;
    std::vector<uint8_t> px;
    uint8_t at(int y, int x) const { return px[static_cast<size_t>(y) * cols + x]; }
};

void put16(std::vector<uint8_t>& o, int v) {
    o.push_back(static_cast<uint8_t>(v >> 8));
    o.push_back(static_cast<uint8_t>(v & 0xFF));
}

void write_dqt(std::vector<uint8_t>& o, int id, const int* q) {
    o.insert(o.end(), {0xFF, 0xDB});
    put16(o, 67);
    o.push_back(static_cast<uint8_t>(id));
    for (int k = 0; k < 64; k++) o.push_back(static_cast<uint8_t>(q[kNatural[k]]));
}

void write_dht(std::vector<uint8_t>& o, int id, const HuffTable& t) {
    o.insert(o.end(), {0xFF, 0xC4});
    put16(o, 2 + 1 + 16 + t.nvals);
    o.push_back(static_cast<uint8_t>(id));
    o.insert(o.end(), t.bits, t.bits + 16);
    o.insert(o.end(), t.vals, t.vals + t.nvals);
}

class Encoder {
   public:
    Encoder(const uint8_t* bgr, int h, int w, int quality) : h_(h), w_(w) {
        const int scale = scaled_quality(quality);
        quant_table(kLumaQuant, scale, q_[0]);
        quant_table(kChromaQuant, scale, q_[1]);
        for (int t = 0; t < 2; t++)
            for (int i = 0; i < 64; i++) div_[t][i] = reciprocal(static_cast<uint32_t>(q_[t][i]) << 3);
        convert(bgr);
    }

    std::vector<uint8_t> encode() {
        std::vector<uint8_t> o;
        o.reserve(static_cast<size_t>(h_) * w_ / 2 + 1024);
        o.insert(o.end(), {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                           0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00});
        write_dqt(o, 0, q_[0]);
        write_dqt(o, 1, q_[1]);
        o.insert(o.end(), {0xFF, 0xC0});
        put16(o, 17);
        o.push_back(8);
        put16(o, h_);
        put16(o, w_);
        o.insert(o.end(), {3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1});
        write_dht(o, 0x00, dc_[0]);
        write_dht(o, 0x10, ac_[0]);
        write_dht(o, 0x01, dc_[1]);
        write_dht(o, 0x11, ac_[1]);
        o.insert(o.end(), {0xFF, 0xDA, 0x00, 0x0C, 3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0});
        scan(o);
        o.insert(o.end(), {0xFF, 0xD9});
        return o;
    }

   private:
    int h_, w_;
    int q_[2][64];
    Divisor div_[2][64];
    HuffTable dc_[2] = {HuffTable(kDcLumaBits, kDcVals, 12), HuffTable(kDcChromaBits, kDcVals, 12)};
    HuffTable ac_[2] = {HuffTable(kAcLumaBits, kAcLumaVals, 162),
                        HuffTable(kAcChromaBits, kAcChromaVals, 162)};
    Plane y_, cb_, cr_;

    // jccolor.c's tables (SCALEBITS 16), jcsample.c's fullsize and h2v2
    // downsampling, jcprepct.c's edge replication.
    void convert(const uint8_t* bgr) {
        const int32_t one_half = 1 << 15, cbcr = 128 << 16;
        auto fix = [](double x) { return static_cast<int32_t>(x * 65536.0 + 0.5); };
        const int32_t ry = fix(0.29900), gy = fix(0.58700), by = fix(0.11400);
        const int32_t rcb = -fix(0.16874), gcb = -fix(0.33126), bcb = fix(0.50000);
        const int32_t gcr = -fix(0.41869), bcr = -fix(0.08131);
        const int mcu_rows = (h_ + 15) / 16, mcu_cols = (w_ + 15) / 16;
        // full-resolution planes, right edge replicated to whole chroma
        // blocks (16 columns), rows replicated to a whole MCU row
        const int rows = mcu_rows * 16, cols = mcu_cols * 16;
        Plane full[3];
        for (auto& p : full) p = {rows, cols, std::vector<uint8_t>(static_cast<size_t>(rows) * cols)};
        for (int y = 0; y < rows; y++) {
            const uint8_t* src = bgr + static_cast<size_t>(std::min(y, h_ - 1)) * w_ * 3;
            for (int x = 0; x < cols; x++) {
                const uint8_t* px = src + std::min(x, w_ - 1) * 3;
                const int32_t b = px[0], g = px[1], r = px[2];
                const size_t i = static_cast<size_t>(y) * cols + x;
                full[0].px[i] = static_cast<uint8_t>((ry * r + gy * g + by * b + one_half) >> 16);
                full[1].px[i] =
                    static_cast<uint8_t>((rcb * r + gcb * g + bcb * b + cbcr + one_half - 1) >> 16);
                full[2].px[i] =
                    static_cast<uint8_t>((bcb * r + gcr * g + bcr * b + cbcr + one_half - 1) >> 16);
            }
        }
        y_ = full[0];
        // h2v2 over the image's rows padded to an even count; the
        // downsampled rows then repeat the last one down to the MCU row
        const int crows = mcu_rows * 8, ccols = mcu_cols * 8;
        const int src_rows = (h_ + 1) / 2;
        for (int c = 1; c < 3; c++) {
            Plane p{crows, ccols, std::vector<uint8_t>(static_cast<size_t>(crows) * ccols)};
            for (int y = 0; y < crows; y++) {
                const int sy = std::min(y, src_rows - 1) * 2;
                const int y0 = std::min(sy, h_ - 1), y1 = std::min(sy + 1, h_ - 1);
                int bias = 1;
                for (int x = 0; x < ccols; x++) {
                    const int s = full[c].at(y0, 2 * x) + full[c].at(y0, 2 * x + 1) +
                                  full[c].at(y1, 2 * x) + full[c].at(y1, 2 * x + 1);
                    p.px[static_cast<size_t>(y) * ccols + x] = static_cast<uint8_t>((s + bias) >> 2);
                    bias ^= 3;
                }
            }
            (c == 1 ? cb_ : cr_) = std::move(p);
        }
    }

    // Level shift, DCT and quantisation of the block at (by, bx) of a plane.
    void block(const Plane& p, int by, int bx, const Divisor* dv, int16_t* coef) const {
        int32_t ws[64];
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++) ws[y * 8 + x] = p.at(by * 8 + y, bx * 8 + x) - 128;
        fdct_islow(ws);
        for (int i = 0; i < 64; i++) {
            int32_t t = ws[i];
            const bool neg = t < 0;
            if (neg) t = -t;
            uint32_t prod = static_cast<uint32_t>(t + static_cast<int32_t>(dv[i].corr)) * dv[i].recip;
            t = static_cast<int32_t>(prod >> (dv[i].shift + 16));
            coef[i] = static_cast<int16_t>(neg ? -t : t);
        }
    }

    void encode_block(BitWriter& bw, const int16_t* coef, int& last_dc, int tbl) const {
        auto magnitude = [](int v, int& bits) {
            int a = v < 0 ? -v : v;
            int n = 0;
            while (a) {
                n++;
                a >>= 1;
            }
            bits = v < 0 ? v - 1 : v;
            return n;
        };
        int bits;
        int n = magnitude(coef[0] - last_dc, bits);
        last_dc = coef[0];
        bw.put(dc_[tbl].code[n], dc_[tbl].size[n]);
        if (n) bw.put(static_cast<uint32_t>(bits), n);
        int run = 0;
        for (int k = 1; k < 64; k++) {
            const int v = coef[kNatural[k]];
            if (v == 0) {
                run++;
                continue;
            }
            while (run > 15) {
                bw.put(ac_[tbl].code[0xF0], ac_[tbl].size[0xF0]);
                run -= 16;
            }
            n = magnitude(v, bits);
            const int sym = (run << 4) + n;
            bw.put(ac_[tbl].code[sym], ac_[tbl].size[sym]);
            bw.put(static_cast<uint32_t>(bits), n);
            run = 0;
        }
        if (run) bw.put(ac_[tbl].code[0], ac_[tbl].size[0]);
    }

    void scan(std::vector<uint8_t>& o) const {
        BitWriter bw{o};
        const int mcu_rows = (h_ + 15) / 16, mcu_cols = (w_ + 15) / 16;
        const int yb_rows = (h_ + 7) / 8, yb_cols = (w_ + 7) / 8;  // Y blocks holding image data
        int last_dc[3] = {0, 0, 0};
        int16_t coef[4][64];
        int16_t c[64];
        for (int my = 0; my < mcu_rows; my++) {
            for (int mx = 0; mx < mcu_cols; mx++) {
                for (int k = 0; k < 4; k++) {
                    const int by = my * 2 + k / 2, bx = mx * 2 + k % 2;
                    if (by < yb_rows && bx < yb_cols) {
                        block(y_, by, bx, div_[0], coef[k]);
                    } else {  // a dummy block: the DC of the block before it
                        std::memset(coef[k], 0, sizeof coef[k]);
                        coef[k][0] = by < yb_rows ? coef[k - 1][0] : coef[(k / 2) * 2 - 1][0];
                    }
                }
                for (int k = 0; k < 4; k++) encode_block(bw, coef[k], last_dc[0], 0);
                block(cb_, my, mx, div_[1], c);
                encode_block(bw, c, last_dc[1], 1);
                block(cr_, my, mx, div_[1], c);
                encode_block(bw, c, last_dc[2], 1);
            }
        }
        bw.flush();
    }
};

void set_error(char* err, int err_len, const char* msg) {
    if (err && err_len > 0) snprintf(err, static_cast<size_t>(err_len), "%s", msg);
}

}  // namespace

extern "C" {

// Encode ``h`` x ``w`` BGR bytes at ``quality``; returns the encoded size
// (written to ``out`` only where it fits in ``cap``), or -1 with ``err``.
int64_t jpeg_encode(const uint8_t* bgr, int h, int w, int quality, uint8_t* out, int64_t cap,
                    char* err, int err_len) {
    if (h < 1 || w < 1 || h > 65500 || w > 65500) {
        set_error(err, err_len, "image size out of the JPEG range (1..65500 a side)");
        return -1;
    }
    if (quality < 1 || quality > 100) {
        set_error(err, err_len, "quality out of range 1..100");
        return -1;
    }
    try {
        std::vector<uint8_t> bytes = Encoder(bgr, h, w, quality).encode();
        const int64_t n = static_cast<int64_t>(bytes.size());
        if (n <= cap) std::memcpy(out, bytes.data(), bytes.size());
        return n;
    } catch (const std::bad_alloc&) {
        set_error(err, err_len, "out of memory");
        return -1;
    }
}

}  // extern "C"

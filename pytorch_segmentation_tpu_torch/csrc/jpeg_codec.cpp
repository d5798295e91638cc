// JPEG codec of the PyTorch port: the decoder and encoder that the JAX
// package gets from OpenCV (cv2.imread / cv2.imdecode / cv2.imwrite(".jpg"),
// which run libjpeg-turbo with its default settings), written so that its
// output equals theirs bit for bit.
//
// Decoder: baseline and extended sequential (SOF0, SOF1) and progressive
// (SOF2) Huffman frames at 8 bits; restart intervals; 1 (gray) or 3
// components (YCbCr, or RGB where an Adobe APP14 says transform 0; the
// colour space chosen as libjpeg's default_decompress_parms chooses it);
// sampling factors 1..4 whose ratios to the largest are integers. It
// computes what libjpeg-turbo computes by default: the jpeg_idct_islow
// integer IDCT and its range-limit table, fancy upsampling (h2v1, h1v2,
// h2v2 triangle filters with their biases, replication otherwise and where
// a plane is at most 2 samples wide) and the fixed-point ycc_rgb_convert
// tables; gray output is the Y plane (rgb_gray_convert for an RGB file).
// It refuses arithmetic coding, 12-bit, lossless and hierarchical frames,
// 4-component files, truncated or corrupt data and images above 2^26
// pixels, each with its own error code.
//
// Encoder: baseline, 8-bit BGR (4:2:0 YCbCr) or gray, the quality-scaled
// Annex K quantization tables, rgb_ycc_convert, h2v2_downsample with its
// 1, 2 bias, edges replicated and dummy blocks as libjpeg makes them, the
// jfdctint islow FDCT, libjpeg-turbo's reciprocal quantization and the
// Annex K Huffman tables, behind a JFIF APP0 header: the bytes of
// cv2.imwrite(path, img) at its defaults.
//
// Built by pytorch_segmentation_tpu_torch/_native.py at first use:
//   g++ -O2 -shared -fPIC -std=c++17 jpeg_codec.cpp
// ABI: plain C functions, bound with ctypes. Every read of the input is
// bounds-checked; there is no global mutable state and no threading, so
// any number of threads may call the functions at once.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {

// error codes (negative); 0 is success
enum {
    kOk = 0,
    kNotJpeg = -1,       // no SOI marker at the start
    kTruncated = -2,     // the data ends before the image does
    kCorrupt = -3,       // a malformed segment, code or scan
    kArithmetic = -4,    // arithmetic coding (SOF9-11, SOF13-15)
    kUnsupportedFrame = -5,  // 12-bit, lossless or hierarchical frame
    kComponents = -6,    // not 1 or 3 components (CMYK, YCCK, ...)
    kTooLarge = -7,      // above kMaxPixels
    kSampling = -8,      // sampling factors libjpeg cannot upsample
    kIncomplete = -9,    // progressive scans leave coefficients libjpeg
                         // would smooth
    kBadArgument = -10,  // the caller's buffer or shape
    kNoMemory = -11,
    kEncodeOverflow = -12,
};

constexpr int64_t kMaxPixels = int64_t(1) << 26;

// zigzag index -> natural index, with 16 extra entries for corrupt runs
// that overshoot 63 (libjpeg's jpeg_natural_order)
constexpr int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// Annex K tables (libjpeg's jstdhuff.c and jcparam.c)
constexpr uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1,
                                    1, 0, 0, 0, 0, 0, 0, 0};
constexpr uint8_t kDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1,
                                      1, 1, 1, 0, 0, 0, 0, 0};
constexpr uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3,
                                    5, 5, 4, 4, 0, 0, 1, 0x7d};
constexpr uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
constexpr uint8_t kAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4,
                                      7, 5, 4, 4, 0, 1, 2, 0x77};
constexpr uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// natural order
constexpr uint16_t kLumQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
constexpr uint16_t kChromQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jidctint.c / jfdctint.c constants (CONST_BITS 13)
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t F0_298631336 = 2446, F0_390180644 = 3196,
                  F0_541196100 = 4433, F0_765366865 = 6270,
                  F0_899976223 = 7373, F1_175875602 = 9633,
                  F1_501321110 = 12299, F1_847759065 = 15137,
                  F1_961570560 = 16069, F2_053119869 = 16819,
                  F2_562915447 = 20995, F3_072711026 = 25172;

// DESCALE: round and shift right (arithmetic), in 32 bits (the FDCT) or
// 64 (the IDCT, libjpeg's JLONG)
template <typename T>
inline T descale(T x, int n) {
    return (x + (T(1) << (n - 1))) >> n;
}

// ---------------------------------------------------------------------------
// decoder

struct HuffDecode {
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint8_t vals[256];
    uint16_t lookup[512];  // 9-bit lookahead: (length << 8) | value, 0 = miss
};

struct HuffSpec {
    bool defined = false;
    uint8_t bits[17] = {};
    uint8_t vals[256] = {};
};

// libjpeg's jpeg_make_d_derived_tbl; false for a table with too many codes
// of a length, or a DC table whose symbols exceed 15
bool derive_decode(const HuffSpec& spec, bool is_dc, HuffDecode* t) {
    int huffsize[257];
    uint32_t huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l)
        for (int i = 0; i < spec.bits[l]; ++i) {
            if (p >= 256) return false;
            huffsize[p++] = l;
        }
    const int numsymbols = p;
    huffsize[p] = 0;
    uint32_t code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
        while (huffsize[p] == si) huffcode[p++] = code++;
        if (code >= (uint32_t(1) << si)) return false;
        code <<= 1;
        ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
        if (spec.bits[l]) {
            t->valoffset[l] = p - int32_t(huffcode[p]);
            p += spec.bits[l];
            t->maxcode[l] = int32_t(huffcode[p - 1]);
        } else {
            t->maxcode[l] = -1;
        }
    }
    t->maxcode[17] = 0x7fffffff;
    std::memcpy(t->vals, spec.vals, 256);
    std::memset(t->lookup, 0, sizeof(t->lookup));
    p = 0;
    for (int l = 1; l <= 9; ++l)
        for (int i = 0; i < spec.bits[l]; ++i, ++p) {
            uint32_t look = huffcode[p] << (9 - l);
            for (int c = 0; c < (1 << (9 - l)); ++c)
                t->lookup[look + c] = uint16_t((l << 8) | spec.vals[p]);
        }
    if (is_dc)
        for (int i = 0; i < numsymbols; ++i)
            if (spec.vals[i] > 15) return false;
    return true;
}

// the entropy-coded bytes of a scan, MSB first, FF 00 unstuffed; at a
// marker or the end of the data it supplies zero bits, and consuming one of
// those sets `overrun`
struct BitReader {
    const uint8_t* d = nullptr;
    size_t n = 0;
    size_t pos = 0;
    uint64_t acc = 0;
    int cnt = 0;
    int pad = 0;          // trailing zero bits in acc that are not data
    int marker = -1;      // marker code hit, -2 the end of the data
    size_t marker_pos = 0;  // index of the FF that starts it
    bool overrun = false;

    void start(const uint8_t* data, size_t len, size_t at) {
        d = data; n = len; pos = at;
        acc = 0; cnt = 0; pad = 0; marker = -1; overrun = false;
    }
    void refill() {
        while (cnt <= 56) {
            uint32_t c = 0;
            if (marker != -1) {
                pad += 8;
            } else if (pos >= n) {
                marker = -2;
                pad += 8;
            } else {
                c = d[pos];
                if (c != 0xFF) {
                    ++pos;
                } else {
                    size_t q = pos + 1;
                    while (q < n && d[q] == 0xFF) ++q;
                    if (q >= n) {
                        marker = -2; pad += 8; c = 0;
                    } else if (d[q] == 0) {
                        pos = q + 1;  // FF (FF...) 00: one FF data byte
                    } else {
                        marker = d[q]; marker_pos = pos; pad += 8; c = 0;
                    }
                }
            }
            acc |= uint64_t(c) << (56 - cnt);
            cnt += 8;
        }
    }
    inline uint32_t peek(int k) {
        if (cnt < k) refill();
        return uint32_t(acc >> (64 - k));
    }
    inline void skip(int k) {
        acc <<= k;
        cnt -= k;
        if (cnt < pad) overrun = true;
    }
    inline int32_t get(int k) {
        if (k == 0) return 0;
        uint32_t v = peek(k);
        skip(k);
        return int32_t(v);
    }
    // position after the scan data: the next marker's FF, skipping any
    // bytes that are not a marker as libjpeg's next_marker does; -1 if none
    int64_t next_marker() {
        if (marker >= 0) return int64_t(marker_pos);
        if (marker == -2) return -1;
        size_t q = pos;
        for (;;) {
            while (q < n && d[q] != 0xFF) ++q;
            while (q < n && d[q] == 0xFF) ++q;
            if (q >= n) return -1;
            if (d[q] != 0) return int64_t(q - 1);
            ++q;  // FF 00 outside the scan data: skipped
        }
    }
};

inline int32_t extend(int32_t v, int s) {
    return v < (int32_t(1) << (s - 1)) ? v + (int32_t(-1) * (1 << s)) + 1
                                        : v;
}

inline int huff_decode(BitReader& br, const HuffDecode& t) {
    uint32_t look = br.peek(16);
    uint16_t hit = t.lookup[look >> 7];
    if (hit) {
        br.skip(hit >> 8);
        return hit & 0xFF;
    }
    for (int l = 10; l <= 16; ++l) {
        int32_t code = int32_t(look >> (16 - l));
        if (code <= t.maxcode[l]) {
            br.skip(l);
            int idx = t.valoffset[l] + code;
            if (idx < 0 || idx > 255) return -1;
            return t.vals[idx];
        }
    }
    return -1;  // no code of 16 bits or fewer
}

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int bw = 0, bh = 0;    // blocks with image data (width_in_blocks, ...)
    int bw_pad = 0, bh_pad = 0;  // blocks stored (whole MCUs)
    int dw = 0, dh = 0;    // downsampled_width / downsampled_height
    bool latched = false;
    int16_t qt[64] = {};   // natural order, as libjpeg's ISLOW_MULT_TYPE
    int coef_bits[64];
    int dc_tbl = 0, ac_tbl = 0;
    int32_t dc_pred = 0;
    std::vector<int16_t> coefs;
};

// the range-limit table that jpeg_idct_islow indexes with (x & 1023)
struct IdctLimit {
    uint8_t t[1024];
    IdctLimit() {
        for (int i = 0; i < 1024; ++i) {
            if (i < 128) t[i] = uint8_t(128 + i);
            else if (i < 512) t[i] = 255;
            else if (i < 896) t[i] = 0;
            else t[i] = uint8_t(i - 896);
        }
    }
};

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out,
                int stride, const uint8_t* limit) {
    int32_t ws[64];  // int, as libjpeg's workspace
    for (int c = 0; c < 8; ++c) {
        const int16_t* ip = in + c;
        const int16_t* qp = q + c;
        int32_t* wp = ws + c;
        if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
            !ip[56]) {
            int32_t dc = int32_t(int64_t(ip[0]) * qp[0] * (1 << kPass1Bits));
            for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
            continue;
        }
        int64_t z2 = int64_t(ip[16]) * qp[16];
        int64_t z3 = int64_t(ip[48]) * qp[48];
        int64_t z1 = (z2 + z3) * F0_541196100;
        int64_t tmp2 = z1 + z3 * (-F1_847759065);
        int64_t tmp3 = z1 + z2 * F0_765366865;
        z2 = int64_t(ip[0]) * qp[0];
        z3 = int64_t(ip[32]) * qp[32];
        int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
        int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = int64_t(ip[56]) * qp[56];
        tmp1 = int64_t(ip[40]) * qp[40];
        tmp2 = int64_t(ip[24]) * qp[24];
        tmp3 = int64_t(ip[8]) * qp[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * F1_175875602;
        tmp0 *= F0_298631336;
        tmp1 *= F2_053119869;
        tmp2 *= F3_072711026;
        tmp3 *= F1_501321110;
        z1 *= -F0_899976223;
        z2 *= -F2_562915447;
        z3 *= -F1_961570560;
        z4 *= -F0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int sh = kConstBits - kPass1Bits;
        wp[0] = int32_t(descale(tmp10 + tmp3, sh));
        wp[56] = int32_t(descale(tmp10 - tmp3, sh));
        wp[8] = int32_t(descale(tmp11 + tmp2, sh));
        wp[48] = int32_t(descale(tmp11 - tmp2, sh));
        wp[16] = int32_t(descale(tmp12 + tmp1, sh));
        wp[40] = int32_t(descale(tmp12 - tmp1, sh));
        wp[24] = int32_t(descale(tmp13 + tmp0, sh));
        wp[32] = int32_t(descale(tmp13 - tmp0, sh));
    }
    const int sh = kConstBits + kPass1Bits + 3;
    for (int r = 0; r < 8; ++r) {
        const int32_t* wp = ws + 8 * r;
        uint8_t* op = out + size_t(r) * stride;
        if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] &&
            !wp[7]) {
            uint8_t v = limit[descale(int64_t(wp[0]), kPass1Bits + 3) & 1023];
            for (int c = 0; c < 8; ++c) op[c] = v;
            continue;
        }
        int64_t z2 = wp[2], z3 = wp[6];
        int64_t z1 = (z2 + z3) * F0_541196100;
        int64_t tmp2 = z1 + z3 * (-F1_847759065);
        int64_t tmp3 = z1 + z2 * F0_765366865;
        int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (1 << kConstBits);
        int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (1 << kConstBits);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = wp[7];
        tmp1 = wp[5];
        tmp2 = wp[3];
        tmp3 = wp[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * F1_175875602;
        tmp0 *= F0_298631336;
        tmp1 *= F2_053119869;
        tmp2 *= F3_072711026;
        tmp3 *= F1_501321110;
        z1 *= -F0_899976223;
        z2 *= -F2_562915447;
        z3 *= -F1_961570560;
        z4 *= -F0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        op[0] = limit[descale(tmp10 + tmp3, sh) & 1023];
        op[7] = limit[descale(tmp10 - tmp3, sh) & 1023];
        op[1] = limit[descale(tmp11 + tmp2, sh) & 1023];
        op[6] = limit[descale(tmp11 - tmp2, sh) & 1023];
        op[2] = limit[descale(tmp12 + tmp1, sh) & 1023];
        op[5] = limit[descale(tmp12 - tmp1, sh) & 1023];
        op[3] = limit[descale(tmp13 + tmp0, sh) & 1023];
        op[4] = limit[descale(tmp13 - tmp0, sh) & 1023];
    }
}

inline uint8_t clamp255(int v) {
    return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// libjpeg's ycc_rgb_convert tables (SCALEBITS 16)
struct YccTables {
    int cr_r[256], cb_b[256];
    int32_t cr_g[256], cb_g[256];
    YccTables() {
        const int32_t half = int32_t(1) << 15;
        auto fix = [](double x) {
            return int32_t(x * double(int32_t(1) << 16) + 0.5);
        };
        for (int i = 0, x = -128; i < 256; ++i, ++x) {
            cr_r[i] = (fix(1.40200) * x + half) >> 16;
            cb_b[i] = (fix(1.77200) * x + half) >> 16;
            cr_g[i] = -fix(0.71414) * x;
            cb_g[i] = -fix(0.34414) * x + half;
        }
    }
};

struct Frame {
    bool seen = false;
    bool progressive = false;
    int width = 0, height = 0;
    int ncomp = 0;
    int max_h = 1, max_v = 1;
    int mcux = 0, mcuy = 0;
    Component comp[3];
};

struct Decoder {
    const uint8_t* d;
    size_t n;
    size_t pos = 0;
    Frame f;
    uint16_t qtab[4][64];
    bool qdef[4] = {false, false, false, false};
    HuffSpec dc_spec[4], ac_spec[4];
    int restart_interval = 0;
    bool saw_jfif = false, saw_adobe = false;
    int adobe_transform = 0;

    Decoder(const uint8_t* data, size_t len) : d(data), n(len) {}

    int u16(size_t at, int* v) const {
        if (at + 2 > n) return kTruncated;
        *v = (d[at] << 8) | d[at + 1];
        return kOk;
    }

    // the next marker code from `pos` (libjpeg's next_marker: bytes that
    // are not FF are skipped, FF fill bytes swallowed, FF 00 skipped)
    int next_marker(int* code) {
        for (;;) {
            while (pos < n && d[pos] != 0xFF) ++pos;
            while (pos < n && d[pos] == 0xFF) ++pos;
            if (pos >= n) return kTruncated;
            int c = d[pos++];
            if (c != 0) {
                *code = c;
                return kOk;
            }
        }
    }

    // [pos, pos + len) is the segment's content after its length field
    int segment(size_t* start, size_t* len) {
        int length;
        int rc = u16(pos, &length);
        if (rc) return rc;
        if (length < 2) return kCorrupt;
        if (pos + size_t(length) > n) return kTruncated;
        *start = pos + 2;
        *len = size_t(length) - 2;
        pos += size_t(length);
        return kOk;
    }

    int read_dqt(size_t s, size_t len) {
        size_t e = s + len;
        while (s < e) {
            int pq = d[s] >> 4, tq = d[s] & 15;
            ++s;
            if (tq > 3 || pq > 1) return kCorrupt;
            size_t need = pq ? 128 : 64;
            if (s + need > e) return kCorrupt;
            for (int i = 0; i < 64; ++i) {
                int v = pq ? (d[s + 2 * i] << 8) | d[s + 2 * i + 1]
                           : d[s + i];
                qtab[tq][kNatural[i]] = uint16_t(v);
            }
            qdef[tq] = true;
            s += need;
        }
        return kOk;
    }

    int read_dht(size_t s, size_t len) {
        size_t e = s + len;
        while (s < e) {
            if (s + 17 > e) return kCorrupt;
            int tc = d[s] >> 4, th = d[s] & 15;
            if (tc > 1 || th > 3) return kCorrupt;
            HuffSpec spec;
            int total = 0;
            for (int l = 1; l <= 16; ++l) {
                spec.bits[l] = d[s + l];
                total += spec.bits[l];
            }
            s += 17;
            if (total > 256 || s + size_t(total) > e) return kCorrupt;
            std::memcpy(spec.vals, d + s, size_t(total));
            s += size_t(total);
            spec.defined = true;
            (tc ? ac_spec : dc_spec)[th] = spec;
        }
        return kOk;
    }

    int read_sof(int marker, size_t s, size_t len) {
        if (f.seen) return kCorrupt;  // a second frame header
        if (len < 6) return kCorrupt;
        int prec = d[s];
        f.height = (d[s + 1] << 8) | d[s + 2];
        f.width = (d[s + 3] << 8) | d[s + 4];
        f.ncomp = d[s + 5];
        if (prec != 8) return kUnsupportedFrame;
        if (f.ncomp != 1 && f.ncomp != 3) return kComponents;
        if (len != 6 + 3 * size_t(f.ncomp)) return kCorrupt;
        if (f.width <= 0 || f.height <= 0) return kCorrupt;
        if (int64_t(f.width) * f.height > kMaxPixels) return kTooLarge;
        f.progressive = marker == 0xC2;
        f.max_h = f.max_v = 1;
        for (int i = 0; i < f.ncomp; ++i) {
            Component& c = f.comp[i];
            const uint8_t* p = d + s + 6 + 3 * i;
            c.id = p[0];
            c.h = p[1] >> 4;
            c.v = p[1] & 15;
            c.tq = p[2];
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) return kCorrupt;
            if (c.tq > 3) return kCorrupt;
            f.max_h = std::max(f.max_h, c.h);
            f.max_v = std::max(f.max_v, c.v);
        }
        f.mcux = (f.width + 8 * f.max_h - 1) / (8 * f.max_h);
        f.mcuy = (f.height + 8 * f.max_v - 1) / (8 * f.max_v);
        for (int i = 0; i < f.ncomp; ++i) {
            Component& c = f.comp[i];
            for (int j = 0; j < i; ++j)
                if (f.comp[j].id == c.id) return kCorrupt;
            if (f.max_h % c.h || f.max_v % c.v) return kSampling;
            c.dw = int((int64_t(f.width) * c.h + f.max_h - 1) / f.max_h);
            c.dh = int((int64_t(f.height) * c.v + f.max_v - 1) / f.max_v);
            c.bw = int((int64_t(f.width) * c.h + 8 * f.max_h - 1) /
                       (8 * f.max_h));
            c.bh = int((int64_t(f.height) * c.v + 8 * f.max_v - 1) /
                       (8 * f.max_v));
            c.bw_pad = f.ncomp == 1 ? c.bw : f.mcux * c.h;
            c.bh_pad = f.ncomp == 1 ? c.bh : f.mcuy * c.v;
            for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
        }
        f.seen = true;
        return kOk;
    }

    void read_app(int marker, size_t s, size_t len) {
        if (marker == 0xE0 && len >= 14 && std::memcmp(d + s, "JFIF\0", 5) ==
                                               0)
            saw_jfif = true;
        if (marker == 0xEE && len >= 12 &&
            std::memcmp(d + s, "Adobe", 5) == 0) {
            saw_adobe = true;
            adobe_transform = d[s + 11];
        }
    }

    // parse markers up to and including the first SOF (the header call)
    int read_header() {
        if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) return kNotJpeg;
        pos = 2;
        for (;;) {
            int m;
            int rc = next_marker(&m);
            if (rc) return rc;
            rc = handle_marker(m);
            if (rc) return rc;
            if (f.seen) return kOk;
            if (m == 0xDA || m == 0xD9) return kCorrupt;
        }
    }

    // a marker other than SOS / EOI; returns an error for one that ends or
    // refuses the image
    int handle_marker(int m) {
        size_t s, len;
        int rc;
        switch (m) {
        case 0xC0: case 0xC1: case 0xC2:
            if ((rc = segment(&s, &len))) return rc;
            return read_sof(m, s, len);
        case 0xC3: case 0xC5: case 0xC6: case 0xC7:
            return kUnsupportedFrame;
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
            return kArithmetic;
        case 0xC4:
            if ((rc = segment(&s, &len))) return rc;
            return read_dht(s, len);
        case 0xDB:
            if ((rc = segment(&s, &len))) return rc;
            return read_dqt(s, len);
        case 0xDD:
            if ((rc = segment(&s, &len))) return rc;
            if (len != 2) return kCorrupt;
            restart_interval = (d[s] << 8) | d[s + 1];
            return kOk;
        case 0xCC: case 0xDC: case 0xFE:  // DAC, DNL, COM
            return segment(&s, &len);
        case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5:
        case 0xD6: case 0xD7: case 0x01:  // stray RSTn, TEM
            return kOk;
        case 0xD8:
            return kCorrupt;  // SOI inside the image
        case 0xDA: case 0xD9:
            return kOk;
        default:
            if (m >= 0xE0 && m <= 0xEF) {
                if ((rc = segment(&s, &len))) return rc;
                read_app(m, s, len);
                return kOk;
            }
            return kCorrupt;  // JPG, DHP, EXP, JPGn, RESn
        }
    }

    // one scan: from the SOS segment to the marker after its data
    int read_scan(size_t s, size_t len, HuffDecode* tables) {
        if (!f.seen) return kCorrupt;
        if (len < 1) return kCorrupt;
        int ns = d[s];
        if (ns < 1 || ns > 4 || len != 4 + 2 * size_t(ns)) return kCorrupt;
        Component* sc[4];
        for (int i = 0; i < ns; ++i) {
            int id = d[s + 1 + 2 * i], tt = d[s + 2 + 2 * i];
            Component* c = nullptr;
            for (int k = 0; k < f.ncomp; ++k)
                if (f.comp[k].id == id) c = &f.comp[k];
            if (!c) return kCorrupt;
            for (int j = 0; j < i; ++j)
                if (sc[j] == c) return kCorrupt;
            c->dc_tbl = tt >> 4;
            c->ac_tbl = tt & 15;
            if (c->dc_tbl > 3 || c->ac_tbl > 3) return kCorrupt;
            sc[i] = c;
        }
        const uint8_t* p = d + s + 1 + 2 * ns;
        int ss = p[0], se = p[1], ah = p[2] >> 4, al = p[2] & 15;
        // latch each component's quantization table at its first scan
        for (int i = 0; i < ns; ++i) {
            Component* c = sc[i];
            if (c->latched) continue;
            if (!qdef[c->tq]) return kCorrupt;
            for (int k = 0; k < 64; ++k) c->qt[k] = int16_t(qtab[c->tq][k]);
            c->latched = true;
        }
        int blocks = 0;
        for (int i = 0; i < ns; ++i) blocks += sc[i]->h * sc[i]->v;
        if (ns > 1 && blocks > 10) return kCorrupt;
        for (int i = 0; i < ns; ++i) {
            if (sc[i]->coefs.empty())
                sc[i]->coefs.assign(
                    size_t(sc[i]->bw_pad) * sc[i]->bh_pad * 64, 0);
        }
        // tables, and the progression's checks
        enum { kSeq, kDcFirst, kDcRefine, kAcFirst, kAcRefine } kind;
        if (!f.progressive) {
            kind = kSeq;  // Ss/Se/Ah/Al other than 0/63/0/0 are ignored
        } else {
            bool dc = ss == 0;
            bool bad = dc ? se != 0 : (ss > se || se > 63 || ns != 1);
            if (ah != 0 && al != ah - 1) bad = true;
            if (al > 13) bad = true;
            if (bad) return kCorrupt;
            for (int i = 0; i < ns; ++i) {
                int* cb = sc[i]->coef_bits;
                if (!dc && cb[0] < 0) return kCorrupt;
                for (int k = ss; k <= se; ++k) {
                    int expected = cb[k] < 0 ? 0 : cb[k];
                    if (ah != expected) return kCorrupt;
                    cb[k] = al;
                }
            }
            kind = dc ? (ah ? kDcRefine : kDcFirst)
                      : (ah ? kAcRefine : kAcFirst);
        }
        auto table = [&](bool is_dc, int no, HuffDecode* out) {
            HuffSpec spec = (is_dc ? dc_spec : ac_spec)[no];
            if (!spec.defined) {
                // libjpeg-turbo's jpeg_std_huff_table for tables 0 and 1
                if (no > 1) return false;
                const uint8_t* bits = is_dc ? (no ? kDcChromBits : kDcLumBits)
                                            : (no ? kAcChromBits : kAcLumBits);
                const uint8_t* vals = is_dc ? kDcVals
                                            : (no ? kAcChromVals : kAcLumVals);
                int total = 0;
                for (int l = 1; l <= 16; ++l) {
                    spec.bits[l] = bits[l];
                    total += bits[l];
                }
                std::memcpy(spec.vals, vals, size_t(total));
            }
            return derive_decode(spec, is_dc, out);
        };
        HuffDecode* dct[4];
        HuffDecode* act[4];
        for (int i = 0; i < ns; ++i) {
            dct[i] = &tables[i];
            act[i] = &tables[4 + i];
            if ((kind == kSeq || kind == kDcFirst) &&
                !table(true, sc[i]->dc_tbl, dct[i]))
                return kCorrupt;
            if ((kind == kSeq || kind == kAcFirst || kind == kAcRefine) &&
                !table(false, sc[i]->ac_tbl, act[i]))
                return kCorrupt;
        }

        // the MCU layout
        int mcus_x, mcus_y;
        if (ns == 1) {
            mcus_x = sc[0]->bw;
            mcus_y = sc[0]->bh;
        } else {
            mcus_x = f.mcux;
            mcus_y = f.mcuy;
        }
        for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
        BitReader br;
        br.start(d, n, pos);
        int eobrun = 0;
        int restarts_to_go = restart_interval;
        int next_rst = 0;
        const int64_t total = int64_t(mcus_x) * mcus_y;
        const int p1 = 1 << al;
        const int m1 = -1 * (1 << al);
        for (int64_t m = 0; m < total; ++m) {
            if (restart_interval) {
                if (restarts_to_go == 0) {
                    int64_t at = br.next_marker();
                    if (at < 0) return kTruncated;
                    size_t q = size_t(at);
                    while (q < n && d[q] == 0xFF) ++q;
                    if (q >= n) return kTruncated;
                    if (d[q] != 0xD0 + next_rst) return kCorrupt;
                    next_rst = (next_rst + 1) & 7;
                    br.start(d, n, q + 1);
                    for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
                    eobrun = 0;
                    restarts_to_go = restart_interval;
                }
                --restarts_to_go;
            }
            int mx = int(m % mcus_x), my = int(m / mcus_x);
            for (int i = 0; i < ns; ++i) {
                Component* c = sc[i];
                int bh = ns == 1 ? 1 : c->v, bwn = ns == 1 ? 1 : c->h;
                for (int by = 0; by < bh; ++by)
                    for (int bx = 0; bx < bwn; ++bx) {
                        int x = ns == 1 ? mx : mx * c->h + bx;
                        int y = ns == 1 ? my : my * c->v + by;
                        int16_t* blk = c->coefs.data() +
                                       (size_t(y) * c->bw_pad + x) * 64;
                        if (kind == kSeq || kind == kDcFirst) {
                            int s0 = huff_decode(br, *dct[i]);
                            if (s0 < 0) return kCorrupt;
                            int32_t diff = s0 ? extend(br.get(s0), s0) : 0;
                            c->dc_pred = int32_t(uint32_t(c->dc_pred) +
                                                 uint32_t(diff));
                            if (kind == kDcFirst)
                                blk[0] = int16_t(uint32_t(c->dc_pred) << al);
                            else
                                blk[0] = int16_t(c->dc_pred);
                        }
                        if (kind == kSeq) {
                            for (int k = 1; k < 64; ++k) {
                                int rs = huff_decode(br, *act[i]);
                                if (rs < 0) return kCorrupt;
                                int r = rs >> 4, sz = rs & 15;
                                if (sz) {
                                    k += r;
                                    blk[kNatural[k]] =
                                        int16_t(extend(br.get(sz), sz));
                                } else {
                                    if (r != 15) break;
                                    k += 15;
                                }
                            }
                        } else if (kind == kDcRefine) {
                            if (br.get(1)) blk[0] = int16_t(blk[0] | p1);
                        } else if (kind == kAcFirst) {
                            if (eobrun > 0) {
                                --eobrun;
                            } else {
                                for (int k = ss; k <= se; ++k) {
                                    int rs = huff_decode(br, *act[i]);
                                    if (rs < 0) return kCorrupt;
                                    int r = rs >> 4, sz = rs & 15;
                                    if (sz) {
                                        k += r;
                                        int32_t v = extend(br.get(sz), sz);
                                        blk[kNatural[k]] = int16_t(
                                            uint32_t(v) << al);
                                    } else if (r == 15) {
                                        k += 15;
                                    } else {
                                        eobrun = 1 << r;
                                        if (r) eobrun += br.get(r);
                                        --eobrun;
                                        break;
                                    }
                                }
                            }
                        } else if (kind == kAcRefine) {
                            int k = ss;
                            if (eobrun == 0) {
                                for (; k <= se; ++k) {
                                    int rs = huff_decode(br, *act[i]);
                                    if (rs < 0) return kCorrupt;
                                    int r = rs >> 4, sz = rs & 15;
                                    int newv = 0;
                                    if (sz) {
                                        newv = br.get(1) ? p1 : m1;
                                    } else if (r != 15) {
                                        eobrun = 1 << r;
                                        if (r) eobrun += br.get(r);
                                        break;
                                    }
                                    do {
                                        int16_t* coef = blk + kNatural[k];
                                        if (*coef != 0) {
                                            if (br.get(1) &&
                                                (*coef & p1) == 0)
                                                *coef = int16_t(
                                                    *coef + (*coef >= 0
                                                                 ? p1
                                                                 : m1));
                                        } else if (--r < 0) {
                                            break;
                                        }
                                        ++k;
                                    } while (k <= se);
                                    if (newv) blk[kNatural[k]] =
                                        int16_t(newv);
                                }
                            }
                            if (eobrun > 0) {
                                for (; k <= se; ++k) {
                                    int16_t* coef = blk + kNatural[k];
                                    if (*coef != 0 && br.get(1) &&
                                        (*coef & p1) == 0)
                                        *coef = int16_t(
                                            *coef + (*coef >= 0 ? p1 : m1));
                                }
                                --eobrun;
                            }
                        }
                        if (br.overrun)
                            return br.marker == -2 ? kTruncated : kCorrupt;
                    }
            }
        }
        int64_t at = br.next_marker();
        if (at < 0) return kTruncated;
        pos = size_t(at);
        return kOk;
    }

    int decode_all() {
        if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) return kNotJpeg;
        pos = 2;
        std::vector<HuffDecode> tables(8);
        bool scanned = false;
        for (;;) {
            int m;
            int rc = next_marker(&m);
            if (rc) return rc;
            if (m == 0xD9) return scanned ? kOk : kCorrupt;
            if (m == 0xDA) {
                size_t s, len;
                if ((rc = segment(&s, &len))) return rc;
                if ((rc = read_scan(s, len, tables.data()))) return rc;
                scanned = true;
                continue;
            }
            if ((rc = handle_marker(m))) return rc;
        }
    }

    // what libjpeg's smoothing_ok would say after the last scan: true if it
    // would smooth the blocks (coefficients left incomplete)
    bool would_smooth() const {
        if (!f.progressive) return false;
        static const int kQ[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
        bool useful = false;
        for (int i = 0; i < f.ncomp; ++i) {
            const Component& c = f.comp[i];
            if (!c.latched) return false;
            for (int k : kQ)
                if (c.qt[k] == 0) return false;
            if (c.coef_bits[0] < 0) return false;
            for (int k = 1; k < 10; ++k)
                if (c.coef_bits[k] != 0) useful = true;
        }
        return useful;
    }
};

// the component's samples at the output size [H][W] (libjpeg's upsampler
// for a component of factors (h, v) under (max_h, max_v))
void upsample(const Component& c, const uint8_t* plane, int stride,
              const Frame& f, uint8_t* out) {
    const int W = f.width, H = f.height;
    const int hx = f.max_h / c.h, vx = f.max_v / c.v;
    const int dw = c.dw, dh = c.dh;
    std::vector<int> cs;
    if (hx == 1 && vx == 1) {
        for (int y = 0; y < H; ++y)
            std::memcpy(out + size_t(y) * W, plane + size_t(y) * stride,
                        size_t(W));
    } else if (hx == 2 && vx == 1 && dw > 2) {  // h2v1 fancy
        std::vector<uint8_t> row(size_t(2) * dw);
        for (int y = 0; y < H; ++y) {
            const uint8_t* in = plane + size_t(y) * stride;
            uint8_t* o = row.data();
            for (int i = 0; i < dw; ++i) {
                int v3 = in[i] * 3;
                int l = in[i > 0 ? i - 1 : 0], r = in[i < dw - 1 ? i + 1 : i];
                o[2 * i] = uint8_t((v3 + l + 1) >> 2);
                o[2 * i + 1] = uint8_t((v3 + r + 2) >> 2);
            }
            std::memcpy(out + size_t(y) * W, o, size_t(W));
        }
    } else if (hx == 1 && vx == 2) {  // h1v2 fancy
        for (int y = 0; y < H; ++y) {
            int j = y >> 1;
            const uint8_t* in0 = plane + size_t(j) * stride;
            int jn = (y & 1) ? std::min(j + 1, dh - 1) : std::max(j - 1, 0);
            const uint8_t* in1 = plane + size_t(jn) * stride;
            int bias = (y & 1) ? 2 : 1;
            uint8_t* o = out + size_t(y) * W;
            for (int x = 0; x < W; ++x)
                o[x] = uint8_t((in0[x] * 3 + in1[x] + bias) >> 2);
        }
    } else if (hx == 2 && vx == 2 && dw > 2) {  // h2v2 fancy
        cs.resize(size_t(dw));
        std::vector<uint8_t> row(size_t(2) * dw);
        for (int y = 0; y < H; ++y) {
            int j = y >> 1;
            const uint8_t* in0 = plane + size_t(j) * stride;
            int jn = (y & 1) ? std::min(j + 1, dh - 1) : std::max(j - 1, 0);
            const uint8_t* in1 = plane + size_t(jn) * stride;
            for (int i = 0; i < dw; ++i) cs[size_t(i)] = in0[i] * 3 + in1[i];
            uint8_t* o = row.data();
            for (int i = 0; i < dw; ++i) {
                int t = cs[size_t(i)] * 3;
                int l = cs[size_t(i > 0 ? i - 1 : 0)];
                int r = cs[size_t(i < dw - 1 ? i + 1 : i)];
                o[2 * i] = uint8_t((t + l + 8) >> 4);
                o[2 * i + 1] = uint8_t((t + r + 7) >> 4);
            }
            std::memcpy(out + size_t(y) * W, o, size_t(W));
        }
    } else {  // replication (int_upsample, h2v1_upsample, h2v2_upsample)
        for (int y = 0; y < H; ++y) {
            const uint8_t* in = plane + size_t(y / vx) * stride;
            uint8_t* o = out + size_t(y) * W;
            for (int x = 0; x < W; ++x) o[x] = in[x / hx];
        }
    }
}

int decode_jpeg(const uint8_t* data, size_t len, int gray, uint8_t* out,
                int width, int height) {
    Decoder dec(data, len);
    int rc = dec.decode_all();
    if (rc) return rc;
    const Frame& f = dec.f;
    if (f.width != width || f.height != height) return kBadArgument;
    if (dec.would_smooth()) return kIncomplete;
    bool rgb = false;  // libjpeg's default_decompress_parms
    if (f.ncomp == 3) {
        if (dec.saw_jfif) rgb = false;
        else if (dec.saw_adobe) rgb = dec.adobe_transform == 0;
        else rgb = f.comp[0].id == 82 && f.comp[1].id == 71 &&
                   f.comp[2].id == 66;
    }
    static const IdctLimit limit;
    static const YccTables ycc;
    const int W = f.width, H = f.height;
    const int needed = (f.ncomp == 1 || (gray && !rgb)) ? 1 : 3;
    std::vector<uint8_t> full[3];
    for (int ci = 0; ci < needed; ++ci) {
        const Component& c = f.comp[ci];
        const int stride = c.bw * 8;
        std::vector<uint8_t> plane(size_t(stride) * c.bh * 8);
        if (!c.coefs.empty()) {
            for (int by = 0; by < c.bh; ++by)
                for (int bx = 0; bx < c.bw; ++bx)
                    idct_islow(c.coefs.data() +
                                   (size_t(by) * c.bw_pad + bx) * 64,
                               c.qt, plane.data() + size_t(by) * 8 * stride +
                                         size_t(bx) * 8,
                               stride, limit.t);
        } else {  // no scan coded the component: all coefficients 0
            std::memset(plane.data(), 128, plane.size());
        }
        full[ci].resize(size_t(W) * H);
        upsample(c, plane.data(), stride, f, full[ci].data());
    }
    const size_t npix = size_t(W) * H;
    if (gray) {
        if (needed == 1) {
            std::memcpy(out, full[0].data(), npix);
        } else {  // rgb_gray_convert
            const int32_t ry = int32_t(0.29900 * 65536 + 0.5);
            const int32_t gy = int32_t(0.58700 * 65536 + 0.5);
            const int32_t by = int32_t(0.11400 * 65536 + 0.5);
            for (size_t i = 0; i < npix; ++i)
                out[i] = uint8_t((ry * full[0][i] + gy * full[1][i] +
                                  by * full[2][i] + (int32_t(1) << 15)) >>
                                 16);
        }
        return kOk;
    }
    if (needed == 1) {
        for (size_t i = 0; i < npix; ++i)
            out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = full[0][i];
    } else if (rgb) {
        for (size_t i = 0; i < npix; ++i) {
            out[3 * i] = full[2][i];
            out[3 * i + 1] = full[1][i];
            out[3 * i + 2] = full[0][i];
        }
    } else {
        for (size_t i = 0; i < npix; ++i) {
            int y = full[0][i], cb = full[1][i], cr = full[2][i];
            out[3 * i + 2] = clamp255(y + ycc.cr_r[cr]);
            out[3 * i + 1] =
                clamp255(y + ((ycc.cb_g[cb] + ycc.cr_g[cr]) >> 16));
            out[3 * i] = clamp255(y + ycc.cb_b[cb]);
        }
    }
    return kOk;
}

// ---------------------------------------------------------------------------
// encoder

struct HuffEncode {
    uint32_t code[256];
    uint8_t size[256];
};

void derive_encode(const uint8_t* bits, const uint8_t* vals, HuffEncode* t) {
    std::memset(t->size, 0, sizeof(t->size));
    uint32_t code = 0;
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
        for (int i = 0; i < bits[l]; ++i, ++p) {
            t->code[vals[p]] = code++;
            t->size[vals[p]] = uint8_t(l);
        }
        code <<= 1;
    }
}

struct BitWriter {
    uint8_t* out;
    size_t cap;
    size_t len = 0;
    uint64_t acc = 0;
    int cnt = 0;
    bool overflow = false;

    void byte(uint8_t b) {
        if (len < cap) out[len++] = b;
        else overflow = true;
    }
    void put(uint32_t bits, int n) {
        if (n == 0) return;
        acc = (acc << n) | (bits & ((uint32_t(1) << n) - 1));
        cnt += n;
        while (cnt >= 8) {
            uint8_t b = uint8_t(acc >> (cnt - 8));
            byte(b);
            if (b == 0xFF) byte(0);
            cnt -= 8;
        }
    }
    void flush() {  // libjpeg's flush_bits: the partial byte filled with 1s
        put(0x7F, 7);
        cnt = 0;
        acc = 0;
    }
};

void fdct_islow(int32_t* data) {
    int32_t* p = data;
    for (int r = 0; r < 8; ++r, p += 8) {
        int32_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
        int32_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
        int32_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
        int32_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
        int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        p[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
        p[4] = (tmp10 - tmp11) * (1 << kPass1Bits);
        int32_t z1 = (tmp12 + tmp13) * F0_541196100;
        p[2] = descale(z1 + tmp13 * F0_765366865, kConstBits - kPass1Bits);
        p[6] = descale(z1 + tmp12 * (-F1_847759065), kConstBits - kPass1Bits);
        z1 = tmp4 + tmp7;
        int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
        int32_t z5 = (z3 + z4) * F1_175875602;
        tmp4 *= F0_298631336;
        tmp5 *= F2_053119869;
        tmp6 *= F3_072711026;
        tmp7 *= F1_501321110;
        z1 *= -F0_899976223;
        z2 *= -F2_562915447;
        z3 *= -F1_961570560;
        z4 *= -F0_390180644;
        z3 += z5;
        z4 += z5;
        p[7] = descale(tmp4 + z1 + z3, kConstBits - kPass1Bits);
        p[5] = descale(tmp5 + z2 + z4, kConstBits - kPass1Bits);
        p[3] = descale(tmp6 + z2 + z3, kConstBits - kPass1Bits);
        p[1] = descale(tmp7 + z1 + z4, kConstBits - kPass1Bits);
    }
    p = data;
    for (int c = 0; c < 8; ++c, ++p) {
        int32_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
        int32_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
        int32_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
        int32_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
        int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        p[0] = descale(tmp10 + tmp11, kPass1Bits);
        p[32] = descale(tmp10 - tmp11, kPass1Bits);
        int32_t z1 = (tmp12 + tmp13) * F0_541196100;
        p[16] = descale(z1 + tmp13 * F0_765366865, kConstBits + kPass1Bits);
        p[48] = descale(z1 + tmp12 * (-F1_847759065),
                        kConstBits + kPass1Bits);
        z1 = tmp4 + tmp7;
        int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
        int32_t z5 = (z3 + z4) * F1_175875602;
        tmp4 *= F0_298631336;
        tmp5 *= F2_053119869;
        tmp6 *= F3_072711026;
        tmp7 *= F1_501321110;
        z1 *= -F0_899976223;
        z2 *= -F2_562915447;
        z3 *= -F1_961570560;
        z4 *= -F0_390180644;
        z3 += z5;
        z4 += z5;
        p[56] = descale(tmp4 + z1 + z3, kConstBits + kPass1Bits);
        p[40] = descale(tmp5 + z2 + z4, kConstBits + kPass1Bits);
        p[24] = descale(tmp6 + z2 + z3, kConstBits + kPass1Bits);
        p[8] = descale(tmp7 + z1 + z4, kConstBits + kPass1Bits);
    }
}

// libjpeg-turbo's compute_reciprocal for a divisor of quantval << 3
struct Divisor {
    uint32_t recip, corr;
    int shift;  // total right shift
};

Divisor reciprocal(uint32_t divisor) {
    int b = 0;
    while ((divisor >> (b + 1)) != 0) ++b;  // flss(divisor) - 1
    int r = 16 + b;
    uint32_t fq = (uint32_t(1) << r) / divisor;
    uint32_t fr = (uint32_t(1) << r) % divisor;
    uint32_t c = divisor / 2;
    if (fr == 0) {
        fq >>= 1;
        --r;
    } else if (fr <= divisor / 2) {
        ++c;
    } else {
        ++fq;
    }
    return {fq, c, r};
}

void quality_table(const uint16_t* basic, int quality, uint16_t* out) {
    if (quality <= 0) quality = 1;
    if (quality > 100) quality = 100;
    int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    for (int i = 0; i < 64; ++i) {
        long t = (long(basic[i]) * scale + 50L) / 100L;
        if (t <= 0) t = 1;
        if (t > 255) t = 255;  // force_baseline
        out[i] = uint16_t(t);
    }
}

void encode_block(const uint8_t* plane, int stride, int bx, int by,
                  const Divisor* div, int16_t* coef) {
    int32_t ws[64];
    for (int r = 0; r < 8; ++r) {
        const uint8_t* row = plane + size_t(by * 8 + r) * stride + bx * 8;
        for (int c = 0; c < 8; ++c) ws[8 * r + c] = int32_t(row[c]) - 128;
    }
    fdct_islow(ws);
    for (int i = 0; i < 64; ++i) {
        int32_t t = ws[i];
        uint32_t a = uint32_t(t < 0 ? -t : t);
        // 16-bit DCTELEM arithmetic, as libjpeg-turbo's SIMD builds
        uint32_t prod = uint32_t(uint16_t(a + div[i].corr)) * div[i].recip;
        int32_t q = int32_t(prod >> div[i].shift);
        coef[i] = int16_t(t < 0 ? -q : q);
    }
}

inline int nbits(int32_t v) {
    int n = 0;
    while (v) {
        ++n;
        v >>= 1;
    }
    return n;
}

void emit_block(BitWriter& bw, const int16_t* coef, int32_t* last_dc,
                const HuffEncode& dc, const HuffEncode& ac) {
    int32_t t = coef[0] - *last_dc;
    *last_dc = coef[0];
    int32_t a = t < 0 ? -t : t;
    int n = nbits(a);
    bw.put(dc.code[n], dc.size[n]);
    if (n) bw.put(uint32_t(t < 0 ? t - 1 : t), n);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
        int32_t v = coef[kNatural[k]];
        if (v == 0) {
            ++run;
            continue;
        }
        while (run > 15) {
            bw.put(ac.code[0xF0], ac.size[0xF0]);
            run -= 16;
        }
        a = v < 0 ? -v : v;
        n = nbits(a);
        int sym = (run << 4) + n;
        bw.put(ac.code[sym], ac.size[sym]);
        bw.put(uint32_t(v < 0 ? v - 1 : v), n);
        run = 0;
    }
    if (run > 0) bw.put(ac.code[0], ac.size[0]);
}

void put16(BitWriter& bw, int v) {
    bw.byte(uint8_t(v >> 8));
    bw.byte(uint8_t(v & 0xFF));
}

void write_dht(BitWriter& bw, int index, const uint8_t* bits,
               const uint8_t* vals) {
    int total = 0;
    for (int l = 1; l <= 16; ++l) total += bits[l];
    bw.byte(0xFF);
    bw.byte(0xC4);
    put16(bw, 2 + 1 + 16 + total);
    bw.byte(uint8_t(index));
    for (int l = 1; l <= 16; ++l) bw.byte(bits[l]);
    for (int i = 0; i < total; ++i) bw.byte(vals[i]);
}

int encode_jpeg(const uint8_t* img, int W, int H, int channels, int quality,
                uint8_t* out, size_t cap, size_t* written) {
    if (W <= 0 || H <= 0 || W > 65535 || H > 65535 ||
        (channels != 1 && channels != 3))
        return kBadArgument;
    const bool color = channels == 3;
    const int nc = color ? 3 : 1;
    const int mh = color ? 2 : 1;  // max sampling factor, both directions
    uint16_t qt[2][64];
    quality_table(kLumQuant, quality, qt[0]);
    quality_table(kChromQuant, quality, qt[1]);
    Divisor div[2][64];
    for (int t = 0; t < 2; ++t)
        for (int i = 0; i < 64; ++i) div[t][i] = reciprocal(uint32_t(qt[t][i]) << 3);

    // component planes, padded as libjpeg pads them
    const int wib[3] = {(W + 7) / 8, (W + 15) / 16, (W + 15) / 16};
    const int mcux = (W + 8 * mh - 1) / (8 * mh);
    const int mcuy = (H + 8 * mh - 1) / (8 * mh);
    const int rows_y = mcuy * 8 * mh;   // rows kept for every component
    std::vector<uint8_t> plane[3];
    int stride[3];
    const int hib[3] = {(H + 7) / 8, (H + 15) / 16, (H + 15) / 16};
    if (!color) {
        stride[0] = wib[0] * 8;
        plane[0].resize(size_t(stride[0]) * hib[0] * 8);
        for (int y = 0; y < hib[0] * 8; ++y) {
            const uint8_t* in = img + size_t(std::min(y, H - 1)) * W;
            uint8_t* o = plane[0].data() + size_t(y) * stride[0];
            std::memcpy(o, in, size_t(W));
            std::memset(o + W, in[W - 1], size_t(stride[0] - W));
        }
    } else {
        // rgb_ycc_convert over the rows of whole row groups (H rounded up to
        // even, the last row repeated) and the columns the downsampler
        // reads (the last column repeated)
        const int cw = wib[1] * 16;               // full-res width read
        const int rows = (H + 1) / 2 * 2;
        std::vector<uint8_t> full[3];
        for (int c = 0; c < 3; ++c) full[c].resize(size_t(cw) * rows);
        int32_t tab[8 * 256];
        const int32_t half = int32_t(1) << 15;
        const int32_t cbcr_off = int32_t(128) << 16;
        auto fix = [](double x) {
            return int32_t(x * double(int32_t(1) << 16) + 0.5);
        };
        for (int i = 0; i < 256; ++i) {
            tab[i] = fix(0.29900) * i;
            tab[256 + i] = fix(0.58700) * i;
            tab[512 + i] = fix(0.11400) * i + half;
            tab[768 + i] = -fix(0.16874) * i;
            tab[1024 + i] = -fix(0.33126) * i;
            tab[1280 + i] = fix(0.50000) * i + cbcr_off + half - 1;
            tab[1536 + i] = -fix(0.41869) * i;
            tab[1792 + i] = -fix(0.08131) * i;
        }
        for (int y = 0; y < rows; ++y) {
            const uint8_t* in = img + size_t(std::min(y, H - 1)) * W * 3;
            uint8_t* oy = full[0].data() + size_t(y) * cw;
            uint8_t* ob = full[1].data() + size_t(y) * cw;
            uint8_t* orr = full[2].data() + size_t(y) * cw;
            for (int x = 0; x < W; ++x) {
                int b = in[3 * x], g = in[3 * x + 1], r = in[3 * x + 2];
                oy[x] = uint8_t((tab[r] + tab[256 + g] + tab[512 + b]) >> 16);
                ob[x] = uint8_t((tab[768 + r] + tab[1024 + g] +
                                 tab[1280 + b]) >> 16);
                orr[x] = uint8_t((tab[1280 + r] + tab[1536 + g] +
                                  tab[1792 + b]) >> 16);
            }
            for (int x = W; x < cw; ++x) {
                oy[x] = oy[W - 1];
                ob[x] = ob[W - 1];
                orr[x] = orr[W - 1];
            }
        }
        // Y: fullsize, width_in_blocks * 8 columns, rows past H repeat
        stride[0] = wib[0] * 8;
        plane[0].resize(size_t(stride[0]) * rows_y);
        for (int y = 0; y < rows_y; ++y)
            std::memcpy(plane[0].data() + size_t(y) * stride[0],
                        full[0].data() + size_t(std::min(y, rows - 1)) * cw,
                        size_t(stride[0]));
        // Cb, Cr: h2v2_downsample of the row groups, then the last row
        // repeated to whole blocks
        const int crow = rows / 2;
        for (int c = 1; c < 3; ++c) {
            stride[c] = wib[c] * 8;
            plane[c].resize(size_t(stride[c]) * hib[c] * 8);
            for (int y = 0; y < hib[c] * 8; ++y) {
                uint8_t* o = plane[c].data() + size_t(y) * stride[c];
                if (y >= crow) {
                    std::memcpy(o, plane[c].data() +
                                       size_t(crow - 1) * stride[c],
                                size_t(stride[c]));
                    continue;
                }
                const uint8_t* in0 = full[c].data() + size_t(2 * y) * cw;
                const uint8_t* in1 = in0 + cw;
                int bias = 1;
                for (int x = 0; x < stride[c]; ++x) {
                    o[x] = uint8_t((in0[2 * x] + in0[2 * x + 1] +
                                    in1[2 * x] + in1[2 * x + 1] + bias) >>
                                   2);
                    bias ^= 3;
                }
            }
        }
    }

    HuffEncode dc[2], ac[2];
    derive_encode(kDcLumBits, kDcVals, &dc[0]);
    derive_encode(kAcLumBits, kAcLumVals, &ac[0]);
    derive_encode(kDcChromBits, kDcVals, &dc[1]);
    derive_encode(kAcChromBits, kAcChromVals, &ac[1]);

    BitWriter bw{out, cap};
    static const uint8_t kHead[20] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10,
                                      'J',  'F',  'I',  'F',  0x00, 0x01,
                                      0x01, 0x00, 0x00, 0x01, 0x00, 0x01,
                                      0x00, 0x00};
    for (uint8_t b : kHead) bw.byte(b);
    for (int t = 0; t < (color ? 2 : 1); ++t) {
        bw.byte(0xFF);
        bw.byte(0xDB);
        put16(bw, 67);
        bw.byte(uint8_t(t));
        for (int i = 0; i < 64; ++i) bw.byte(uint8_t(qt[t][kNatural[i]]));
    }
    bw.byte(0xFF);
    bw.byte(0xC0);
    put16(bw, 8 + 3 * nc);
    bw.byte(8);
    put16(bw, H);
    put16(bw, W);
    bw.byte(uint8_t(nc));
    for (int c = 0; c < nc; ++c) {
        bw.byte(uint8_t(c + 1));
        bw.byte(c == 0 ? uint8_t((mh << 4) | mh) : 0x11);
        bw.byte(c == 0 ? 0 : 1);
    }
    write_dht(bw, 0x00, kDcLumBits, kDcVals);
    write_dht(bw, 0x10, kAcLumBits, kAcLumVals);
    if (color) {
        write_dht(bw, 0x01, kDcChromBits, kDcVals);
        write_dht(bw, 0x11, kAcChromBits, kAcChromVals);
    }
    bw.byte(0xFF);
    bw.byte(0xDA);
    put16(bw, 6 + 2 * nc);
    bw.byte(uint8_t(nc));
    for (int c = 0; c < nc; ++c) {
        bw.byte(uint8_t(c + 1));
        bw.byte(c == 0 ? 0x00 : 0x11);
    }
    bw.byte(0);
    bw.byte(63);
    bw.byte(0);

    int32_t last_dc[3] = {0, 0, 0};
    int16_t blk[4][64];
    if (!color) {
        for (int by = 0; by < hib[0]; ++by)
            for (int bx = 0; bx < wib[0]; ++bx) {
                encode_block(plane[0].data(), stride[0], bx, by, div[0],
                             blk[0]);
                emit_block(bw, blk[0], &last_dc[0], dc[0], ac[0]);
            }
    } else {
        for (int my = 0; my < mcuy; ++my)
            for (int mx = 0; mx < mcux; ++mx) {
                // Y: 2 x 2 blocks; those past width_in_blocks or
                // height_in_blocks are dummies, AC 0 and the DC of the
                // block before them
                for (int j = 0; j < 2; ++j) {
                    int by = my * 2 + j;
                    for (int i = 0; i < 2; ++i) {
                        int bx = mx * 2 + i;
                        int16_t* b = blk[j * 2 + i];
                        if (by < hib[0] && bx < wib[0]) {
                            encode_block(plane[0].data(), stride[0], bx, by,
                                         div[0], b);
                        } else {
                            std::memset(b, 0, 64 * sizeof(int16_t));
                            b[0] = by < hib[0] ? blk[j * 2 + i - 1][0]
                                               : blk[1][0];
                        }
                    }
                }
                for (int k = 0; k < 4; ++k)
                    emit_block(bw, blk[k], &last_dc[0], dc[0], ac[0]);
                for (int c = 1; c < 3; ++c) {
                    encode_block(plane[c].data(), stride[c], mx, my, div[1],
                                 blk[0]);
                    emit_block(bw, blk[0], &last_dc[c], dc[1], ac[1]);
                }
            }
    }
    bw.flush();
    bw.byte(0xFF);
    bw.byte(0xD9);
    if (bw.overflow) return kEncodeOverflow;
    *written = bw.len;
    return kOk;
}

}  // namespace

extern "C" {

// The frame's width and height, from the markers up to the first SOF.
// Returns 0 or a negative error code.
int pseg_jpeg_header(const uint8_t* data, size_t len, int* width,
                     int* height) {
    try {
        Decoder dec(data, len);
        int rc = dec.read_header();
        if (rc) return rc;
        *width = dec.f.width;
        *height = dec.f.height;
        return kOk;
    } catch (const std::bad_alloc&) {
        return kNoMemory;
    }
}

// Decode into `out`: [height][width][3] BGR, or [height][width] when `gray`
// (the sizes pseg_jpeg_header gave). Returns 0 or a negative error code.
int pseg_jpeg_decode(const uint8_t* data, size_t len, int gray, uint8_t* out,
                     int width, int height) {
    try {
        return decode_jpeg(data, len, gray, out, width, height);
    } catch (const std::bad_alloc&) {
        return kNoMemory;
    }
}

// An upper bound on the bytes pseg_jpeg_encode writes.
size_t pseg_jpeg_encode_bound(int width, int height, int channels) {
    size_t mcus = size_t((width + 15) / 16 + 1) * size_t((height + 15) / 16 + 1);
    size_t blocks = channels == 3 ? 6 * mcus : 4 * mcus;
    return 2048 + blocks * 512;
}

// Encode uint8 [height][width][channels] (3: BGR, 1: gray) as baseline
// JPEG at `quality`; the byte count goes to *written.
int pseg_jpeg_encode(const uint8_t* img, int width, int height, int channels,
                     int quality, uint8_t* out, size_t cap, size_t* written) {
    try {
        return encode_jpeg(img, width, height, channels, quality, out, cap,
                           written);
    } catch (const std::bad_alloc&) {
        return kNoMemory;
    }
}

}  // extern "C"

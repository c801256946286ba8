// The port's native host runtime (counterpart of dtlr_tpu/runtime/native.cpp),
// built with the host's C++ compiler by ops/_build.py and bound with ctypes
// by runtime/native.py:
//   - levenshtein_u32, edit_ops_u32: edit distance and the edit-operation
//     backtrace over uint32 token sequences (eval/metrics.py)
//   - resize_bilinear_f32: the half-pixel bilinear upscale of float32 HWC
//     images (data/transforms.py)
//   - normalize_into_f32: ImageNet normalization into a padded batch row
//     (data/batching.py)
//   - png_unfilter_u8: undo the PNG row filters (data/images.py)
//   - jpeg_decode_huffman: a sequential or progressive JPEG's entropy-coded
//     scans through the colour conversion, as libjpeg-turbo decodes them
//     by default (data/images.py parses the headers and tables)
//   - tiff_packbits_u8, tiff_lzw_u8: expand a TIFF strip (data/images.py)
//
// Built with -ffp-contract=off: the multiply-adds that the JAX package's
// build (-march=native) contracts into fused ones are written here as
// std::fma / std::fmaf, so the results do not depend on the host.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

// ----------------------------------------------------------------- JPEG

// zigzag position -> natural index, with libjpeg's 16 extra entries that
// keep a corrupt run inside the block (jutils.c)
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// A Huffman table: 9-bit lookahead, then canonical decoding by length.
struct Huffman {
    uint16_t look[512];       // (length << 8) | symbol, 0 where the code is longer
    int32_t maxcode[18];      // largest code of each length, -1 if none
    int32_t valoffset[17];    // symbol index of a code = code + valoffset[length]
    uint8_t values[256];

    void build(const uint8_t* spec) {  // 16 counts, then 256 symbols
        std::memcpy(values, spec + 16, 256);
        std::memset(look, 0, sizeof(look));
        int32_t code = 0, k = 0;
        for (int len = 1; len <= 16; ++len) {
            const int count = spec[len - 1];
            valoffset[len] = k - code;
            for (int i = 0; i < count; ++i, ++code, ++k) {
                if (len <= 9) {
                    const int lo = code << (9 - len), hi = (code + 1) << (9 - len);
                    for (int p = lo; p < hi && p < 512; ++p)
                        look[p] = (uint16_t)((len << 8) | values[k & 255]);
                }
            }
            maxcode[len] = count ? code - 1 : -1;
            code <<= 1;
        }
        maxcode[17] = 0x7FFFFFFF;
    }
};

// MSB-first bits of one entropy-coded segment, FF00 unstuffed. A marker
// ends the data: zeros follow, and once a decode consumes them the rest
// of the restart interval is left zero (jdhuff.c's insufficient_data).
struct BitReader {
    const uint8_t* data;
    int64_t pos, end, limit;
    uint64_t acc = 0;
    int nbits = 0, padded = 0;
    bool insufficient = false;

    void fill() {
        while (nbits <= 56) {
            uint8_t byte = 0;
            if (pos < end) {
                byte = data[pos++];
                if (byte == 0xFF) {
                    const uint8_t next = pos < end ? data[pos] : 0;
                    if (next == 0) {
                        ++pos;
                    } else {
                        --pos;
                        end = pos;
                        byte = 0;
                        padded += 8;
                    }
                }
            } else {
                padded += 8;
            }
            acc = (acc << 8) | byte;
            nbits += 8;
        }
    }
    void consumed() {
        if (nbits < padded) {
            insufficient = true;
            padded = nbits;
        }
    }
    int peek16() {
        if (nbits < 16) fill();
        return (int)((acc >> (nbits - 16)) & 0xFFFF);
    }
    void skip(int n) {
        nbits -= n;
        consumed();
    }
    int bits(int n) {
        if (n == 0) return 0;
        if (nbits < n) fill();
        nbits -= n;
        consumed();
        return (int)((acc >> nbits) & ((1u << n) - 1));
    }
    int decode(const Huffman& h) {
        const int peek = peek16();
        const uint16_t e = h.look[peek >> 7];
        if (e) {
            skip(e >> 8);
            return e & 255;
        }
        for (int len = 10; len <= 16; ++len) {
            const int32_t code = peek >> (16 - len);
            if (code <= h.maxcode[len]) {
                skip(len);
                return h.values[(code + h.valoffset[len]) & 255];
            }
        }
        skip(16);  // no code: a corrupt stream, decoded as symbol 0
        return 0;
    }
    void restart() {  // drop the buffered bits, step over the next RSTn
        acc = 0;
        nbits = padded = 0;
        insufficient = false;
        end = limit;
        for (int64_t p = pos; p + 1 < limit; ++p) {
            if (data[p] == 0xFF && data[p + 1] >= 0xD0 && data[p + 1] <= 0xD7) {
                pos = p + 2;
                return;
            }
        }
    }
};

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r; }

void decode_block(BitReader& br, const Huffman& dc, const Huffman& ac, int& last_dc,
                  int32_t* block) {
    int s = br.decode(dc);
    const int diff = s ? extend(br.bits(s), s) : 0;
    last_dc += diff;
    block[0] = last_dc;
    for (int k = 1; k < 64; ++k) {
        const int rs = br.decode(ac);
        const int r = rs >> 4;
        s = rs & 15;
        if (s) {
            k += r;
            block[kNatural[k]] = extend(br.bits(s), s);
        } else {
            if (r != 15) break;
            k += 15;
        }
    }
}

// One block of a progressive scan (jdphuff.c): DC first or refinement, AC
// first or refinement with the end-of-band run in eobrun.
void decode_progressive(BitReader& br, const Huffman& dc, const Huffman& ac, int ss, int se,
                        int ah, int al, int& last_dc, int& eobrun, int32_t* block) {
    if (ss == 0) {
        if (ah == 0) {
            const int s = br.decode(dc);
            last_dc += s ? extend(br.bits(s), s) : 0;
            block[0] = (int32_t)((uint32_t)last_dc << al);
        } else if (br.bits(1)) {
            block[0] |= 1 << al;
        }
        return;
    }
    if (ah == 0) {
        if (eobrun > 0) {
            --eobrun;
            return;
        }
        for (int k = ss; k <= se; ++k) {
            const int rs = br.decode(ac);
            const int r = rs >> 4, s = rs & 15;
            if (s) {
                k += r;
                block[kNatural[k]] = (int32_t)((uint32_t)extend(br.bits(s), s) << al);
            } else if (r == 15) {
                k += 15;
            } else {
                eobrun = (1 << r) + br.bits(r) - 1;
                break;
            }
        }
        return;
    }
    const int p1 = 1 << al, m1 = -(1 << al);
    auto correct = [&](int pos) {
        if (br.bits(1) && (block[pos] & p1) == 0) block[pos] += block[pos] >= 0 ? p1 : m1;
    };
    int k = ss;
    if (eobrun == 0) {
        for (; k <= se; ++k) {
            const int rs = br.decode(ac);
            int r = rs >> 4, s = rs & 15;
            if (s) {
                s = br.bits(1) ? p1 : m1;
            } else if (r != 15) {
                eobrun = (1 << r) + br.bits(r);
                break;
            }
            while (k <= se) {
                const int pos = kNatural[k];
                if (block[pos] != 0) {
                    correct(pos);
                } else if (--r < 0) {
                    break;
                }
                ++k;
            }
            if (s) block[kNatural[k]] = s;
        }
    }
    if (eobrun > 0) {
        for (; k <= se; ++k)
            if (block[kNatural[k]] != 0) correct(kNatural[k]);
        --eobrun;
    }
}

// jidctint.c (jpeg_idct_islow): CONST_BITS 13, PASS1_BITS 2
constexpr int64_t F0_298631336 = 2446, F0_390180644 = 3196, F0_541196100 = 4433,
                  F0_765366865 = 6270, F0_899976223 = 7373, F1_175875602 = 9633,
                  F1_501321110 = 12299, F1_847759065 = 15137, F1_961570560 = 16069,
                  F2_053119869 = 16819, F2_562915447 = 20995, F3_072711026 = 25172;

// one 8-point butterfly on x[0], x[step], ..., x[7 step]; out[k] descaled
inline void idct_1d(const int64_t* x, int step, int shift, int64_t* out) {
    int64_t z2 = x[2 * step], z3 = x[6 * step];
    int64_t z1 = (z2 + z3) * F0_541196100;
    const int64_t tmp2 = z1 + z3 * -F1_847759065;
    const int64_t tmp3 = z1 + z2 * F0_765366865;
    const int64_t tmp0 = (x[0] + x[4 * step]) * 8192;  // << CONST_BITS
    const int64_t tmp1 = (x[0] - x[4 * step]) * 8192;
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    int64_t t0 = x[7 * step], t1 = x[5 * step], t2 = x[3 * step], t3 = x[1 * step];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    int64_t z4 = t1 + t3;
    const int64_t z5 = (z3 + z4) * F1_175875602;
    t0 *= F0_298631336;
    t1 *= F2_053119869;
    t2 *= F3_072711026;
    t3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 = z3 * -F1_961570560 + z5;
    z4 = z4 * -F0_390180644 + z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    const int64_t half = (int64_t)1 << (shift - 1);
    out[0] = (tmp10 + t3 + half) >> shift;
    out[7] = (tmp10 - t3 + half) >> shift;
    out[1] = (tmp11 + t2 + half) >> shift;
    out[6] = (tmp11 - t2 + half) >> shift;
    out[2] = (tmp12 + t1 + half) >> shift;
    out[5] = (tmp12 - t1 + half) >> shift;
    out[3] = (tmp13 + t0 + half) >> shift;
    out[4] = (tmp13 - t0 + half) >> shift;
}

// jdmaster.c's post-IDCT range limit, indexed by the result masked to 10 bits
struct RangeLimit {
    uint8_t t[1024];
    RangeLimit() {
        for (int i = 0; i < 1024; ++i)
            t[i] = (uint8_t)(i < 128 ? i + 128 : i < 512 ? 255 : i < 896 ? 0 : i - 896);
    }
};

void idct_islow(const int32_t* coef, const uint16_t* quant, uint8_t* dst, int64_t stride,
                const RangeLimit& rl) {
    int64_t x[64], ws[64], col[8], row[8];
    for (int i = 0; i < 64; ++i) x[i] = (int64_t)coef[i] * quant[i];
    for (int c = 0; c < 8; ++c) {  // pass 1: columns
        idct_1d(x + c, 8, 13 - 2, col);
        for (int r = 0; r < 8; ++r) ws[r * 8 + c] = col[r];
    }
    for (int r = 0; r < 8; ++r) {  // pass 2: rows
        idct_1d(ws + r * 8, 1, 13 + 2 + 3, row);
        for (int c = 0; c < 8; ++c) dst[r * stride + c] = rl.t[row[c] & 1023];
    }
}

// jdsample.c's method for a component upsampled by (rh, rv): its samples
// (dw x dh, row stride sstride) to the image's W x H
void upsample(const uint8_t* src, int64_t sstride, int64_t dw, int64_t dh, int rh, int rv,
              uint8_t* dst, int64_t W, int64_t H) {
    auto at = [&](int64_t y, int64_t x) -> int { return src[y * sstride + x]; };
    const bool fancy_h = rh == 2 && dw > 2;
    for (int64_t oy = 0; oy < H; ++oy) {
        uint8_t* out = dst + oy * W;
        if (rh == 1 && rv == 1) {
            std::memcpy(out, src + oy * sstride, W);
        } else if (fancy_h && rv == 1) {  // h2v1: biases 1 and 2
            for (int64_t ox = 0; ox < W; ++ox) {
                const int64_t j = ox >> 1;
                const int64_t nb = (ox & 1) ? std::min(j + 1, dw - 1) : std::max<int64_t>(j - 1, 0);
                out[ox] = (uint8_t)((at(oy, j) * 3 + at(oy, nb) + ((ox & 1) ? 2 : 1)) >> 2);
            }
        } else if (rh == 1 && rv == 2) {  // h1v2: the row above or below, biases 1 and 2
            const int64_t k = oy >> 1;
            const int64_t nb = (oy & 1) ? std::min(k + 1, dh - 1) : std::max<int64_t>(k - 1, 0);
            const int bias = (oy & 1) ? 2 : 1;
            for (int64_t ox = 0; ox < W; ++ox)
                out[ox] = (uint8_t)((at(k, ox) * 3 + at(nb, ox) + bias) >> 2);
        } else if (fancy_h && rv == 2) {  // h2v2 on column sums: biases 8 and 7
            const int64_t k = oy >> 1;
            const int64_t nb = (oy & 1) ? std::min(k + 1, dh - 1) : std::max<int64_t>(k - 1, 0);
            auto colsum = [&](int64_t j) { return at(k, j) * 3 + at(nb, j); };
            for (int64_t ox = 0; ox < W; ++ox) {
                const int64_t j = ox >> 1;
                const int64_t far = (ox & 1) ? std::min(j + 1, dw - 1) : std::max<int64_t>(j - 1, 0);
                out[ox] = (uint8_t)((colsum(j) * 3 + colsum(far) + ((ox & 1) ? 7 : 8)) >> 4);
            }
        } else {  // replication: h2v1 and h2v2 at widths <= 2, any other integral ratio
            const int64_t k = oy / rv;
            for (int64_t ox = 0; ox < W; ++ox) out[ox] = (uint8_t)at(k, ox / rh);
        }
    }
}

int fail(char* err, int64_t errlen, const char* msg) {
    if (err && errlen > 0) std::snprintf(err, (size_t)errlen, "%s", msg);
    return 1;
}

}  // namespace

extern "C" {

// Levenshtein distance between two uint32 sequences.
int64_t levenshtein_u32(const uint32_t* a, int64_t n, const uint32_t* b, int64_t m) {
    if (n == 0) return m;
    if (m == 0) return n;
    std::vector<int64_t> prev(m + 1), cur(m + 1);
    for (int64_t j = 0; j <= m; ++j) prev[j] = j;
    for (int64_t i = 1; i <= n; ++i) {
        cur[0] = i;
        const uint32_t ca = a[i - 1];
        for (int64_t j = 1; j <= m; ++j) {
            const int64_t sub = prev[j - 1] + (ca != b[j - 1]);
            cur[j] = std::min(std::min(prev[j] + 1, cur[j - 1] + 1), sub);
        }
        std::swap(prev, cur);
    }
    return prev[m];
}

// (substitutions, deletions, insertions) turning pred a (n) into gt b (m)
// along one backtrace of the full table: the diagonal first, then a
// deletion (a gt item pred lacks), then an insertion. Writes 3 int64.
void edit_ops_u32(const uint32_t* a, int64_t n, const uint32_t* b, int64_t m, int64_t* out) {
    std::vector<int32_t> dp((n + 1) * (m + 1));
    auto at = [&](int64_t i, int64_t j) -> int32_t& { return dp[i * (m + 1) + j]; };
    for (int64_t i = 0; i <= n; ++i) at(i, 0) = (int32_t)i;
    for (int64_t j = 0; j <= m; ++j) at(0, j) = (int32_t)j;
    for (int64_t i = 1; i <= n; ++i)
        for (int64_t j = 1; j <= m; ++j) {
            const int32_t c = a[i - 1] != b[j - 1];
            at(i, j) = std::min(std::min(at(i - 1, j) + 1, at(i, j - 1) + 1), at(i - 1, j - 1) + c);
        }
    int64_t i = n, j = m, subs = 0, dels = 0, ins = 0;
    while (i > 0 || j > 0) {
        if (i > 0 && j > 0 && at(i, j) == at(i - 1, j - 1) + (a[i - 1] != b[j - 1])) {
            subs += (a[i - 1] != b[j - 1]);
            --i;
            --j;
        } else if (j > 0 && at(i, j) == at(i, j - 1) + 1) {
            ++dels;
            --j;
        } else {
            ++ins;
            --i;
        }
    }
    out[0] = subs;
    out[1] = dels;
    out[2] = ins;
}

// Half-pixel bilinear resize of float32 HWC (edge-clamped). The source
// position and each interpolation are fused multiply-adds, rounded once.
void resize_bilinear_f32(const float* src, int64_t sh, int64_t sw, int64_t c, float* dst,
                         int64_t dh, int64_t dw) {
    const double fy = (double)sh / dh;
    const double fx = (double)sw / dw;
    std::vector<int64_t> x0s(dw), x1s(dw);
    std::vector<float> wxs(dw);
    for (int64_t x = 0; x < dw; ++x) {
        double sxf = std::fma(x + 0.5, fx, -0.5);
        if (sxf < 0) sxf = 0;
        x0s[x] = (int64_t)sxf;
        x1s[x] = std::min(x0s[x] + 1, sw - 1);
        wxs[x] = (float)(sxf - x0s[x]);
    }
    for (int64_t y = 0; y < dh; ++y) {
        double syf = std::fma(y + 0.5, fy, -0.5);
        if (syf < 0) syf = 0;
        const int64_t y0 = (int64_t)syf;
        const int64_t y1 = std::min(y0 + 1, sh - 1);
        const float wy = (float)(syf - y0);
        for (int64_t x = 0; x < dw; ++x) {
            const float wx = wxs[x];
            const float* p00 = src + (y0 * sw + x0s[x]) * c;
            const float* p01 = src + (y0 * sw + x1s[x]) * c;
            const float* p10 = src + (y1 * sw + x0s[x]) * c;
            const float* p11 = src + (y1 * sw + x1s[x]) * c;
            float* out = dst + (y * dw + x) * c;
            for (int64_t k = 0; k < c; ++k) {
                const float top = std::fmaf(p01[k] - p00[k], wx, p00[k]);
                const float bot = std::fmaf(p11[k] - p10[k], wx, p10[k]);
                out[k] = std::fmaf(bot - top, wy, top);
            }
        }
    }
}

// ImageNet-normalize src (h, w, 3) into the top-left corner of dst (H, W, 3).
void normalize_into_f32(const float* src, int64_t h, int64_t w, float* dst, int64_t H, int64_t W,
                        const float* mean, const float* stdv) {
    (void)H;
    for (int64_t y = 0; y < h; ++y) {
        const float* srow = src + y * w * 3;
        float* drow = dst + y * W * 3;
        for (int64_t x = 0; x < w; ++x)
            for (int64_t k = 0; k < 3; ++k) drow[x * 3 + k] = (srow[x * 3 + k] - mean[k]) / stdv[k];
    }
}

// Undo the PNG row filters (spec 9.2) of height rows of 1 + stride bytes,
// bpp bytes per complete pixel, into out (height, stride). Returns -1, or
// the first row whose filter type is not 0-4.
int64_t png_unfilter_u8(const uint8_t* raw, int64_t height, int64_t stride, int64_t bpp,
                        uint8_t* out) {
    for (int64_t y = 0; y < height; ++y) {
        const uint8_t kind = raw[y * (stride + 1)];
        const uint8_t* line = raw + y * (stride + 1) + 1;
        uint8_t* cur = out + y * stride;
        const uint8_t* prior = y ? out + (y - 1) * stride : nullptr;
        for (int64_t x = 0; x < stride; ++x) {
            const int a = x >= bpp ? cur[x - bpp] : 0;
            const int b = prior ? prior[x] : 0;
            int pred;
            switch (kind) {
                case 0: pred = 0; break;
                case 1: pred = a; break;
                case 2: pred = b; break;
                case 3: pred = (a + b) >> 1; break;
                case 4: {
                    const int c = (prior && x >= bpp) ? prior[x - bpp] : 0;
                    const int p = a + b - c;
                    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
                    pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    break;
                }
                default: return y;
            }
            cur[x] = (uint8_t)(line[x] + pred);
        }
    }
    return -1;
}

// Decode a Huffman-coded JPEG (sequential or progressive) whose headers
// data/images.py parsed:
//   data, size          the file
//   width, height, ncomp (1 or 3)
//   sampling            ncomp x (h, v)
//   quant               ncomp x 64, natural order (each component's table
//                       as latched at its first scan)
//   nscans, scans       per scan 20 int64: start, end of its entropy-coded
//                       segment, restart interval, component count,
//                       4 x (component, DC slot, AC slot), then Ss, Se,
//                       Ah, Al
//   progressive         0 sequential, 1 progressive (every scan's blocks
//                       through decode_progressive)
//   tables              per scan 8 x 272 bytes: DC 0-3, AC 0-3 (16
//                       counts, 256 symbols)
//   transform           0 gray, 1 YCbCr to RGB (jdcolor.c), 2 RGB kept
//   out                 height x width x 3
// Returns 0, or 1 with the reason in err.
int jpeg_decode_huffman(const uint8_t* data, int64_t size, int64_t width, int64_t height,
                        int64_t ncomp, const int64_t* sampling, const uint16_t* quant,
                        int64_t nscans, const int64_t* scans, const uint8_t* tables,
                        int64_t progressive, int64_t transform, uint8_t* out, char* err,
                        int64_t errlen) {
    if (ncomp != 1 && ncomp != 3) return fail(err, errlen, "1 or 3 components");
    int64_t hmax = 1, vmax = 1;
    for (int64_t c = 0; c < ncomp; ++c) {
        hmax = std::max(hmax, sampling[2 * c]);
        vmax = std::max(vmax, sampling[2 * c + 1]);
    }
    const int64_t mcux = (width + 8 * hmax - 1) / (8 * hmax);
    const int64_t mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    std::vector<std::vector<int32_t>> coefs(ncomp);
    std::vector<int64_t> bw(ncomp), bh(ncomp), dw(ncomp), dh(ncomp);
    for (int64_t c = 0; c < ncomp; ++c) {
        const int64_t h = sampling[2 * c], v = sampling[2 * c + 1];
        bw[c] = mcux * h;
        bh[c] = mcuy * v;
        dw[c] = (width * h + hmax - 1) / hmax;
        dh[c] = (height * v + vmax - 1) / vmax;
        coefs[c].assign(bw[c] * bh[c] * 64, 0);
    }
    Huffman huff[8];
    for (int64_t s = 0; s < nscans; ++s) {
        const int64_t* sc = scans + 20 * s;
        const int ss = (int)sc[16], se = (int)sc[17], ah = (int)sc[18], al = (int)sc[19];
        if (sc[0] < 0 || sc[1] > size || sc[0] > sc[1]) return fail(err, errlen, "scan bounds");
        for (int t = 0; t < 8; ++t) huff[t].build(tables + (s * 8 + t) * 272);
        BitReader br{data, sc[0], sc[1], sc[1]};
        const int64_t ri = sc[2], ns = sc[3];
        int last_dc[3] = {0, 0, 0};
        int eobrun = 0;
        // a lone component's scan goes block by block over its own
        // samples; an interleaved one MCU by MCU
        const int64_t c0 = sc[4];
        const int64_t units = ns == 1 ? ((dw[c0] + 7) / 8) * ((dh[c0] + 7) / 8) : mcux * mcuy;
        for (int64_t u = 0; u < units; ++u) {
            if (ri && u && u % ri == 0) {
                br.restart();
                last_dc[0] = last_dc[1] = last_dc[2] = 0;
                eobrun = 0;
            }
            if (br.insufficient) continue;  // the rest of the interval stays zero
            if (ns == 1) {
                const int64_t per_row = (dw[c0] + 7) / 8;
                const int64_t by = u / per_row, bx = u % per_row;
                int32_t* block = coefs[c0].data() + (by * bw[c0] + bx) * 64;
                if (progressive)
                    decode_progressive(br, huff[sc[5]], huff[4 + sc[6]], ss, se, ah, al,
                                       last_dc[c0], eobrun, block);
                else
                    decode_block(br, huff[sc[5]], huff[4 + sc[6]], last_dc[c0], block);
                continue;
            }
            const int64_t my = u / mcux, mx = u % mcux;
            for (int64_t k = 0; k < ns; ++k) {
                const int64_t c = sc[4 + 3 * k];
                const int64_t h = sampling[2 * c], v = sampling[2 * c + 1];
                for (int64_t yy = 0; yy < v; ++yy)
                    for (int64_t xx = 0; xx < h; ++xx) {
                        const int64_t by = my * v + yy, bx = mx * h + xx;
                        int32_t* block = coefs[c].data() + (by * bw[c] + bx) * 64;
                        if (progressive)
                            decode_progressive(br, huff[sc[5 + 3 * k]], huff[4 + sc[6 + 3 * k]],
                                               ss, se, ah, al, last_dc[c], eobrun, block);
                        else
                            decode_block(br, huff[sc[5 + 3 * k]], huff[4 + sc[6 + 3 * k]],
                                         last_dc[c], block);
                    }
            }
        }
    }
    static const RangeLimit rl;
    std::vector<std::vector<uint8_t>> planes(ncomp);
    for (int64_t c = 0; c < ncomp; ++c) {
        const int64_t stride = bw[c] * 8;
        std::vector<uint8_t> samples(stride * bh[c] * 8);
        for (int64_t by = 0; by < bh[c]; ++by)
            for (int64_t bx = 0; bx < bw[c]; ++bx)
                idct_islow(coefs[c].data() + (by * bw[c] + bx) * 64, quant + 64 * c,
                           samples.data() + by * 8 * stride + bx * 8, stride, rl);
        const int64_t h = sampling[2 * c], v = sampling[2 * c + 1];
        if (hmax % h || vmax % v) return fail(err, errlen, "fractional sampling factors");
        planes[c].resize(width * height);
        upsample(samples.data(), stride, dw[c], dh[c], (int)(hmax / h), (int)(vmax / v),
                 planes[c].data(), width, height);
    }
    const int64_t n = width * height;
    if (transform == 0) {
        for (int64_t i = 0; i < n; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = planes[0][i];
    } else if (transform == 2) {
        for (int64_t i = 0; i < n; ++i)
            for (int k = 0; k < 3; ++k) out[3 * i + k] = planes[k][i];
    } else {
        // jdcolor.c: SCALEBITS 16, tables over x = sample - 128
        constexpr int64_t one_half = (int64_t)1 << 15;
        auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
        int cr_r[256], cb_b[256];
        int64_t cr_g[256], cb_g[256];
        for (int i = 0; i < 256; ++i) {
            const int64_t x = i - 128;
            cr_r[i] = (int)((fix(1.40200) * x + one_half) >> 16);
            cb_b[i] = (int)((fix(1.77200) * x + one_half) >> 16);
            cr_g[i] = -fix(0.71414) * x;
            cb_g[i] = -fix(0.34414) * x + one_half;
        }
        auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
        for (int64_t i = 0; i < n; ++i) {
            const int y = planes[0][i], cb = planes[1][i], cr = planes[2][i];
            out[3 * i] = clamp(y + cr_r[cr]);
            out[3 * i + 1] = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
            out[3 * i + 2] = clamp(y + cb_b[cb]);
        }
    }
    return 0;
}

// TIFF PackBits (TIFF 6.0 section 9) into out, at most cap bytes.
// Returns the bytes written.
int64_t tiff_packbits_u8(const uint8_t* src, int64_t n, uint8_t* out, int64_t cap) {
    int64_t pos = 0, w = 0;
    while (pos < n && w < cap) {
        const int h = (int8_t)src[pos++];
        if (h >= 0) {
            for (int k = 0; k <= h && pos < n && w < cap; ++k) out[w++] = src[pos++];
            if (pos > n) break;
        } else if (h != -128) {
            if (pos >= n) break;
            const uint8_t v = src[pos++];
            for (int k = 0; k < 1 - h && w < cap; ++k) out[w++] = v;
        }
    }
    return w;
}

// TIFF LZW (TIFF 6.0 section 13): 9- to 12-bit codes, most significant bit
// first, 256 clears, 257 ends, the width grows one code early. Writes at
// most cap bytes into out. Returns the bytes written, or -1 on a code
// beyond the table.
int64_t tiff_lzw_u8(const uint8_t* src, int64_t n, uint8_t* out, int64_t cap) {
    // each entry: its prefix code, its last byte, its first byte, its length
    std::vector<int32_t> prefix(4096), length(4096);
    std::vector<uint8_t> last(4096), first(4096);
    for (int i = 0; i < 256; ++i) {
        prefix[i] = -1;
        last[i] = first[i] = (uint8_t)i;
        length[i] = 1;
    }
    int width = 9, next = 258, prev = -1;
    uint64_t buf = 0;
    int have = 0;
    int64_t pos = 0, w = 0;
    std::vector<uint8_t> stack(4096);
    while (w < cap) {
        while (have < width && pos < n) {
            buf = (buf << 8) | src[pos++];
            have += 8;
        }
        if (have < width) break;
        have -= width;
        const int code = (int)((buf >> have) & ((1u << width) - 1));
        if (code == 257) break;
        if (code == 256) {
            width = 9;
            next = 258;
            prev = -1;
            continue;
        }
        int emit;  // the code whose string goes out
        if (code < next && code != 256 && code != 257) {
            emit = code;
            if (prev >= 0 && next < 4096) {
                prefix[next] = prev;
                last[next] = first[code];
                first[next] = first[prev];
                length[next] = length[prev] + 1;
                ++next;
            }
        } else if (code == next && prev >= 0 && next < 4096) {
            prefix[next] = prev;
            last[next] = first[prev];
            first[next] = first[prev];
            length[next] = length[prev] + 1;
            emit = next++;
        } else {
            return -1;
        }
        // the string, last byte first, then out in order
        int len = length[emit], k = len;
        for (int c = emit; c >= 0; c = prefix[c]) stack[--k] = last[c];
        for (int i = 0; i < len && w < cap; ++i) out[w++] = stack[i];
        prev = code;
        if (next + 1 >= (1 << width) && width < 12) ++width;
    }
    return w;
}

}  // extern "C"

// JPEG decoding for the port's image reader (`data/jpeg.py`), written
// from ITU-T T.81: the Huffman and arithmetic-coded DCT processes
// (baseline and extended sequential, SOF0, SOF1, SOF9; progressive,
// SOF2, SOF10) with 8-bit samples, and the lossless Huffman process
// (SOF3, Annex H) with 2- to 8-bit samples; 1, 3 or 4 components,
// sampling factors 1-4, restart intervals.
//
// It produces, bit for bit, what libjpeg-turbo 3.1 produces for
// `cv2.imread` on x86-64 (islow inverse DCT, fancy upsampling, output in
// BGR, here in RGB):
//
// - The inverse DCT is libjpeg-turbo's AVX2 `jsimd_idct_islow`, not its
//   C `jpeg_idct_islow`: the same CONST_BITS 13 / PASS1_BITS 2 integer
//   algorithm, but the dequantised coefficients are 16-bit products
//   (pmullw), the sums in0 +- in4, in3 + in7 and in1 + in5 wrap at 16
//   bits, each pass saturates its output to 16 bits, and the result is
//   clamped to 0..255 (the C code's range-limit table instead wraps
//   values past +-512).  A block whose rows 1-7 are all zero skips the
//   column pass: its row 0 is dequantised and shifted left by 2 at 16
//   bits.  The two agree wherever nothing overflows.
// - The arithmetic decoder is T.81 Annex D.2's (the QM coder with Table
//   D.2's estimates), with F.2.4's sequential and G.2's progressive
//   procedures, statistics areas of 64 DC and 256 AC bins per table,
//   DAC conditioning (L, U, Kx), signs and refinement bits on a fixed
//   0.5 estimate, and every statistics area and prediction reset at a
//   scan's start and at each restart marker, as libjpeg's jdarith.c.
//   Hitting a marker inside arithmetic-coded data is legal: zero bytes
//   are supplied from there on.
// - Lossless (Annex H): predictors 1-7 on the point-transformed
//   samples modulo 2^16, the first row of a scan and of each restart
//   interval predicted from its left neighbour (its first sample from
//   2^(P - Pt - 1)), the first column from above; restart intervals are
//   whole MCU rows.  As libjpeg's jddiffct.c, the rows of an iMCU row
//   are undifferenced after all of them are decoded, so a restart inside
//   one (a non-interleaved scan of a component with v > 1) makes its
//   first row, not the restart's, the 1-D row.  The output sample is
//   the undifferenced value shifted left by Pt, cut to 8 bits: 2- to
//   7-bit samples come out unscaled, as cv2 returns them.
// - Upsampling follows jinit_upsampler: h2v1 and h2v2 "fancy" triangle
//   filters (biases 1/2 and 8/7) when the downsampled width is > 2, the
//   h1v2 triangle filter (biases 1/2), replication otherwise; edges are
//   replicated (first and last column, top and bottom rows).  Lossless
//   images are upsampled by replication (no fancy filter on 1x1 data
//   units).
// - Colour: jdcolor.c's YCbCr tables (SCALEBITS 16), the colour space
//   chosen at the first scan as default_decompress_parms chooses it: 3
//   components are YCbCr or RGB by the JFIF marker, the Adobe transform
//   flag and the component ids; 4 are CMYK, or YCCK when an Adobe marker
//   has a transform other than 0.  YCCK becomes CMYK as
//   ycck_cmyk_convert does (YCbCr -> RGB unclamped, 255 minus it,
//   clamped; K kept); CMYK becomes RGB as OpenCV's
//   icvCvt_CMYK2BGR_8u_C4C3R does: R = K - ((255 - C) * K >> 8), G and B
//   from M and Y alike.  Grey is replicated.  Lossless mode converts no
//   colour: only RGB and CMYK lossless files are read in colour.
// - Quantisation tables are latched at a component's first scan; missing
//   Huffman tables 0 and 1 take T.81 Annex K's tables at the first scan.
//
// What `cv2.imread` (libjpeg-turbo 3.1.2 in OpenCV 5.0) returns, measured
// on files written by tests/jpeg_craft.py, and what this decoder does:
//
//   file                                     cv2.imread (colour)
//   SOF9 / SOF10 arithmetic, default and     (H, W, 3) uint8, equal to
//     DAC tables, with and without restarts  the Huffman file's decode
//   SOF3 lossless RGB (Adobe 0 or ids R G B),(H, W, 3) uint8: the samples
//     predictors 1-7, Pt 0..P-1, P 2-8,      << Pt, unscaled below 8
//     restarts of whole MCU rows, 2x2/2x1    bits; replicated upsampling
//   SOF3 lossless CMYK (4 components)        CMYK -> BGR as above
//   SOF3 grey, YCbCr or YCCK; P 9-16;        None (refused)
//     restarts not whole rows; predictor 0
//   SOF11 (lossless arithmetic)              None
//   12-bit SOF1, SOF2, SOF9, SOF10           None
//   4 components, Adobe 0 / none / 2 / 1,    (H, W, 3) uint8: CMYK,
//     1x1 and 2x2 sampling                   CMYK, YCCK, YCCK
//   2 components                             None
//
// Anything cv2 refuses raises here, and so do hierarchical processes,
// fractional sampling ratios, and corrupt or truncated data (a bad
// Huffman or arithmetic code, entropy data that runs past its segment or
// past the end of the file, a missing restart marker, a progressive
// image whose scans stop before every coefficient is complete), where
// libjpeg warns and cv2 returns what it decoded.  Bytes between the end
// of a scan and the next marker are skipped, as libjpeg skips them.
//
// C interface: mn_jpeg_decode fills a malloc'd (H, W, 3) RGB buffer that
// mn_jpeg_free releases, and reports the EXIF orientation (1-8, 0 when
// absent) of the first well-formed Exif APP1 segment before the first
// scan; the caller applies it.

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

struct JpegError {
  std::string msg;
};

[[noreturn]] void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof(buf), fmt, ap);
  va_end(ap);
  throw JpegError{buf};
}

// Natural index of each zigzag position; 16 extra entries catch a run
// that overshoots position 63 in corrupt data, as libjpeg's table does.
const uint8_t kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct HuffSpec {
  bool defined = false;
  uint8_t bits[17] = {};  // bits[l]: number of codes of length l
  uint8_t vals[256] = {};
};

// T.81 Annex K.3 tables (luminance and chrominance DC and AC).
const uint8_t kStdBits[4][17] = {
    {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},
    {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcLuma[162] = {
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
const uint8_t kStdAcChroma[162] = {
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

// T.81 Table D.2: the QM coder's probability estimates, per state Qe,
// Next_Index_LPS, Next_Index_MPS and Switch_MPS.  State 113 is a fixed
// estimate of 0.5 (T.851), the bin libjpeg decodes signs and refinement
// bits with.
struct QeState {
  uint16_t qe;
  uint8_t nlps, nmps, sw;
};
const QeState kQe[114] = {
    {0x5a1d, 1, 1, 1},    {0x2586, 14, 2, 0},   {0x1114, 16, 3, 0},
    {0x080b, 18, 4, 0},   {0x03d8, 20, 5, 0},   {0x01da, 23, 6, 0},
    {0x00e5, 25, 7, 0},   {0x006f, 28, 8, 0},   {0x0036, 30, 9, 0},
    {0x001a, 33, 10, 0},  {0x000d, 35, 11, 0},  {0x0006, 9, 12, 0},
    {0x0003, 10, 13, 0},  {0x0001, 12, 13, 0},  {0x5a7f, 15, 15, 1},
    {0x3f25, 36, 16, 0},  {0x2cf2, 38, 17, 0},  {0x207c, 39, 18, 0},
    {0x17b9, 40, 19, 0},  {0x1182, 42, 20, 0},  {0x0cef, 43, 21, 0},
    {0x09a1, 45, 22, 0},  {0x072f, 46, 23, 0},  {0x055c, 48, 24, 0},
    {0x0406, 49, 25, 0},  {0x0303, 51, 26, 0},  {0x0240, 52, 27, 0},
    {0x01b1, 54, 28, 0},  {0x0144, 56, 29, 0},  {0x00f5, 57, 30, 0},
    {0x00b7, 59, 31, 0},  {0x008a, 60, 32, 0},  {0x0068, 62, 33, 0},
    {0x004e, 63, 34, 0},  {0x003b, 32, 35, 0},  {0x002c, 33, 9, 0},
    {0x5ae1, 37, 37, 1},  {0x484c, 64, 38, 0},  {0x3a0d, 65, 39, 0},
    {0x2ef1, 67, 40, 0},  {0x261f, 68, 41, 0},  {0x1f33, 69, 42, 0},
    {0x19a8, 70, 43, 0},  {0x1518, 72, 44, 0},  {0x1177, 73, 45, 0},
    {0x0e74, 74, 46, 0},  {0x0bfb, 75, 47, 0},  {0x09f8, 77, 48, 0},
    {0x0861, 78, 49, 0},  {0x0706, 79, 50, 0},  {0x05cd, 48, 51, 0},
    {0x04de, 50, 52, 0},  {0x040f, 50, 53, 0},  {0x0363, 51, 54, 0},
    {0x02d4, 52, 55, 0},  {0x025c, 53, 56, 0},  {0x01f8, 54, 57, 0},
    {0x01a4, 55, 58, 0},  {0x0160, 56, 59, 0},  {0x0125, 57, 60, 0},
    {0x00f6, 58, 61, 0},  {0x00cb, 59, 62, 0},  {0x00ab, 61, 63, 0},
    {0x008f, 61, 32, 0},  {0x5b12, 65, 65, 1},  {0x4d04, 80, 66, 0},
    {0x412c, 81, 67, 0},  {0x37d8, 82, 68, 0},  {0x2fe8, 83, 69, 0},
    {0x293c, 84, 70, 0},  {0x2379, 86, 71, 0},  {0x1edf, 87, 72, 0},
    {0x1aa9, 87, 73, 0},  {0x174e, 72, 74, 0},  {0x1424, 72, 75, 0},
    {0x119c, 74, 76, 0},  {0x0f6b, 74, 77, 0},  {0x0d51, 75, 78, 0},
    {0x0bb6, 77, 79, 0},  {0x0a40, 77, 48, 0},  {0x5832, 80, 81, 1},
    {0x4d1c, 88, 82, 0},  {0x438e, 89, 83, 0},  {0x3bdd, 90, 84, 0},
    {0x34ee, 91, 85, 0},  {0x2eae, 92, 86, 0},  {0x299a, 93, 87, 0},
    {0x2516, 86, 71, 0},  {0x5570, 88, 89, 1},  {0x4ca9, 95, 90, 0},
    {0x44d9, 96, 91, 0},  {0x3e22, 97, 92, 0},  {0x3824, 99, 93, 0},
    {0x32b4, 99, 94, 0},  {0x2e17, 93, 86, 0},  {0x56a8, 95, 96, 1},
    {0x4f46, 101, 97, 0}, {0x47e5, 102, 98, 0}, {0x41cf, 103, 99, 0},
    {0x3c3d, 104, 100, 0}, {0x375e, 99, 93, 0}, {0x5231, 105, 102, 0},
    {0x4c0f, 106, 103, 0}, {0x4639, 107, 104, 0}, {0x415e, 103, 99, 0},
    {0x5627, 105, 106, 1}, {0x50e7, 108, 107, 0}, {0x4b85, 109, 103, 0},
    {0x5597, 110, 109, 0}, {0x504f, 111, 107, 0}, {0x5a10, 110, 111, 1},
    {0x5522, 112, 109, 0}, {0x59eb, 112, 111, 1}, {0x5a1d, 113, 113, 0}};
constexpr uint8_t kFixedBin = 113;

constexpr int kLookBits = 9;

// A table ready for decoding: canonical codes (jpeg_make_d_derived_tbl)
// and a lookup of the codes of up to kLookBits bits.
struct Huff {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t look[1 << kLookBits];  // (length << 8) | symbol; 0: longer
};

// `max_sym`: the largest symbol a DC table may hold (15, or 16 for the
// lossless difference categories); -1 for an AC table.
void derive(const HuffSpec& s, int max_sym, Huff* h) {
  if (!s.defined) fail("Huffman table not defined");
  int size[257];
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    if (p + s.bits[l] > 256) fail("bad Huffman table");
    for (int i = 0; i < s.bits[l]; i++) size[p++] = l;
  }
  size[p] = 0;
  const int n = p;
  uint32_t code[257];
  uint32_t c = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    if (c >= (1u << si)) fail("bad Huffman table");
    c <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (s.bits[l]) {
      h->valoffset[l] = p - (int32_t)code[p];
      p += s.bits[l];
      h->maxcode[l] = (int32_t)code[p - 1];
    } else {
      h->maxcode[l] = -1;
    }
  }
  h->valoffset[17] = 0;
  h->maxcode[17] = 0xFFFFF;
  memcpy(h->vals, s.vals, sizeof(h->vals));
  memset(h->look, 0, sizeof(h->look));
  for (int i = 0; i < n; i++) {
    if (size[i] > kLookBits) break;
    const int shift = kLookBits - size[i];
    const int base = code[i] << shift;
    for (int j = 0; j < (1 << shift); j++)
      h->look[base + j] = (uint16_t)((size[i] << 8) | s.vals[i]);
  }
  if (max_sym >= 0)
    for (int i = 0; i < n; i++)
      if (s.vals[i] > max_sym) fail("bad Huffman table");
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;  // blocks holding image samples
  int pw = 0, ph = 0;  // blocks stored: bw, bh rounded up to h, v
  int dw = 0, dh = 0;  // samples: ceil(W * h / max_h), ceil(H * v / max_v)
  int dc_tbl = 0, ac_tbl = 0;
  bool latched = false;
  int16_t q[64] = {};  // latched table as 16-bit multipliers
  int coef_bits[64];   // progressive: last Al per coefficient, -1 none
  std::vector<int16_t> coef;  // ph * pw blocks of 64, natural order
  std::vector<uint8_t> plane;  // bh*8 rows of bw*8 samples after IDCT
  // lossless: the differences of one iMCU row (v rows of the MCU grid's
  // width) and the last undifferenced row
  std::vector<int32_t> diff, prev;
  int16_t* block(int r, int c) { return &coef[((size_t)r * pw + c) * 64]; }
};

inline int16_t wrap16(int32_t v) { return (int16_t)(uint16_t)(uint32_t)v; }
inline int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
inline int32_t wsub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
inline int16_t sat16(int32_t v) {
  return (int16_t)(v > 32767 ? 32767 : v < -32768 ? -32768 : v);
}

// One 8-point pass of the AVX2 islow IDCT on 16-bit inputs (stride s),
// outputs descaled by `shift` and saturated to 16 bits (stride t).
inline void idct_pass(const int16_t* in, int s, int16_t* out, int t,
                      int shift) {
  const int32_t i0 = in[0], i1 = in[s], i2 = in[2 * s], i3 = in[3 * s];
  const int32_t i4 = in[4 * s], i5 = in[5 * s], i6 = in[6 * s];
  const int32_t i7 = in[7 * s];
  // even part
  const int32_t tmp3 = i2 * 10703 + i6 * 4433;
  const int32_t tmp2 = i2 * 4433 + i6 * -10704;
  const int32_t tmp0 = (int32_t)wrap16(i0 + i4) * 8192;
  const int32_t tmp1 = (int32_t)wrap16(i0 - i4) * 8192;
  const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  // odd part
  const int32_t z3 = wrap16(i3 + i7), z4 = wrap16(i1 + i5);
  const int32_t z3p = z3 * -6436 + z4 * 9633;
  const int32_t z4p = z3 * 9633 + z4 * 6437;
  const int32_t o0 = i7 * -4927 + i1 * -7373 + z3p;
  const int32_t o1 = i5 * -4176 + i3 * -20995 + z4p;
  const int32_t o2 = i5 * -20995 + i3 * 4177 + z3p;
  const int32_t o3 = i7 * -7373 + i1 * 4926 + z4p;
  const int32_t r = 1 << (shift - 1);
  out[0] = sat16(wadd(wadd(tmp10, r), o3) >> shift);
  out[7 * t] = sat16(wsub(wadd(tmp10, r), o3) >> shift);
  out[t] = sat16(wadd(wadd(tmp11, r), o2) >> shift);
  out[6 * t] = sat16(wsub(wadd(tmp11, r), o2) >> shift);
  out[2 * t] = sat16(wadd(wadd(tmp12, r), o1) >> shift);
  out[5 * t] = sat16(wsub(wadd(tmp12, r), o1) >> shift);
  out[3 * t] = sat16(wadd(wadd(tmp13, r), o0) >> shift);
  out[4 * t] = sat16(wsub(wadd(tmp13, r), o0) >> shift);
}

void idct_block(const int16_t* coef, const int16_t* q, uint8_t* dst,
                int stride) {
  int16_t ws[64];
  bool ac = false;
  for (int i = 8; i < 64; i++) ac |= coef[i] != 0;
  if (!ac) {
    for (int c = 0; c < 8; c++) {
      const int16_t v =
          wrap16((int32_t)((uint32_t)wrap16(coef[c] * q[c]) << 2));
      for (int r = 0; r < 8; r++) ws[r * 8 + c] = v;
    }
  } else {
    int16_t in[64];
    for (int i = 0; i < 64; i++) in[i] = wrap16(coef[i] * q[i]);
    for (int c = 0; c < 8; c++) idct_pass(in + c, 8, ws + c, 8, 11);
  }
  int16_t row[8];
  for (int r = 0; r < 8; r++) {
    idct_pass(ws + r * 8, 1, row, 1, 18);
    for (int c = 0; c < 8; c++) {
      const int v = row[c] > 127 ? 127 : row[c] < -128 ? -128 : row[c];
      dst[r * stride + c] = (uint8_t)(v + 128);
    }
  }
}

// Colour spaces, as default_decompress_parms names them.
enum Space { kGrey, kYCbCr, kRGB, kCMYK, kYCCK };
const char* const kSpaceName[] = {"grey", "YCbCr", "RGB", "CMYK", "YCCK"};

class Decoder {
 public:
  Decoder(const uint8_t* d, size_t n) : d_(d), n_(n) {}

  void run() {
    if (n_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8) fail("not a JPEG file");
    size_t p = 2;
    for (;;) {
      const int m = next_marker(&p);
      if (m < 0) {
        if (scans_ == 0) fail("truncated JPEG data (no image data)");
        break;  // no EOI: the data ended after a complete scan
      }
      if (m == 0xD9) {
        if (scans_ == 0) fail("JPEG data without image data");
        break;
      }
      if (m == 0xD8) fail("duplicate SOI marker");
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      if (p + 2 > n_) fail("truncated JPEG marker segment");
      const size_t len = (d_[p] << 8) | d_[p + 1];
      if (len < 2 || p + len > n_) fail("truncated JPEG marker segment");
      const uint8_t* s = d_ + p + 2;
      const size_t sl = len - 2;
      p += len;
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC9: case 0xCA:
          read_sof(m, s, sl, n_ - p);
          break;
        case 0xCB:
          fail("lossless arithmetic-coded JPEG (SOF11) is not supported");
        case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF:
          fail("hierarchical JPEG (SOF%d) is not supported", m - 0xC0);
        case 0xC4: read_dht(s, sl); break;
        case 0xDB: read_dqt(s, sl); break;
        case 0xCC: read_dac(s, sl); break;
        case 0xDD:
          if (sl != 2) fail("bad DRI marker length");
          restart_interval_ = (s[0] << 8) | s[1];
          break;
        case 0xDA:
          p = read_sos(s, sl, p);
          break;
        case 0xE0:
          if (sl >= 14 && !memcmp(s, "JFIF\0", 5)) jfif_ = true;
          break;
        case 0xE1:
          if (!exif_ && scans_ == 0 && sl >= 6 && !memcmp(s, "Exif\0\0", 6))
            exif_ = exif_orientation(s + 6, sl - 6, &orientation_);
          break;
        case 0xEE:
          if (sl >= 12 && !memcmp(s, "Adobe", 5)) {
            adobe_ = true;
            adobe_transform_ = s[11];
          }
          break;
        case 0xDC: case 0xFE:  // DNL, COM
          break;
        default:
          if (m >= 0xE0 && m <= 0xEF) break;  // other APPn
          fail("unknown JPEG marker 0x%02x", m);
      }
    }
    output();
  }

  int W = 0, H = 0, orientation_ = 0;
  std::vector<uint8_t> rgb;

 private:
  // libjpeg's next_marker: skip bytes up to an FF, then FF fill bytes;
  // FF 00 is skipped as stuffed data.  Returns the marker and moves *p
  // past it, or -1 at the end of the data.
  int next_marker(size_t* p) {
    size_t i = *p;
    for (;;) {
      while (i < n_ && d_[i] != 0xFF) i++;
      while (i < n_ && d_[i] == 0xFF) i++;
      if (i >= n_) return -1;
      if (d_[i] != 0) {
        *p = i + 1;
        return d_[i];
      }
      i++;
    }
  }

  // `rest`: the bytes after the frame header.
  void read_sof(int m, const uint8_t* s, size_t sl, size_t rest) {
    if (sof_) fail("duplicate SOF marker");
    sof_ = true;
    progressive_ = m == 0xC2 || m == 0xCA;
    arith_ = m == 0xC9 || m == 0xCA;
    lossless_ = m == 0xC3;
    if (sl < 6) fail("bad SOF marker length");
    precision_ = s[0];
    if (lossless_) {
      if (precision_ > 8 && precision_ <= 16)
        fail("%d-bit lossless JPEG is not supported", precision_);
      if (precision_ < 2 || precision_ > 16)
        fail("unsupported JPEG sample precision %d", precision_);
    } else {
      if (precision_ == 12) fail("12-bit JPEG is not supported");
      if (precision_ != 8)
        fail("unsupported JPEG sample precision %d", precision_);
    }
    H = (s[1] << 8) | s[2];
    W = (s[3] << 8) | s[4];
    const int nc = s[5];
    if (nc != 1 && nc != 3 && nc != 4)
      fail("%d-component JPEG is not supported", nc);
    if (H == 0 || W == 0) fail("empty JPEG image");
    if (H > 65500 || W > 65500 || (int64_t)W * H > (1 << 30))
      fail("JPEG image too big");  // libjpeg's and cv2's limits
    if (sl != 6 + 3 * (size_t)nc) fail("bad SOF marker length");
    comps_.resize(nc);
    for (int i = 0; i < nc; i++) {
      Component& c = comps_[i];
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        fail("bad JPEG sampling factors");
      if (c.tq > 3) fail("bad JPEG quantisation table number");
      max_h_ = c.h > max_h_ ? c.h : max_h_;
      max_v_ = c.v > max_v_ ? c.v : max_v_;
    }
    const int unit = lossless_ ? 1 : 8;  // samples per data unit side
    mcux_ = (W + unit * max_h_ - 1) / (unit * max_h_);
    mcuy_ = (H + unit * max_v_ - 1) / (unit * max_v_);
    size_t fewest = SIZE_MAX;  // data units of the smallest component
    for (Component& c : comps_) {
      c.dw = (int)(((int64_t)W * c.h + max_h_ - 1) / max_h_);
      c.dh = (int)(((int64_t)H * c.v + max_v_ - 1) / max_v_);
      c.bw = (c.dw + 7) / 8;
      c.bh = (c.dh + 7) / 8;
      c.pw = (c.bw + c.h - 1) / c.h * c.h;
      c.ph = (c.bh + c.v - 1) / c.v * c.v;
      const size_t nb = lossless_ ? (size_t)c.dw * c.dh
                                  : (size_t)c.bw * c.bh;
      fewest = nb < fewest ? nb : fewest;
    }
    // Any decodable file holds one complete DC, sequential or lossless
    // scan of a component, at least a bit per data unit: refuse a cut
    // file before allocating what its header asks for.
    if (rest < fewest / 8) fail("truncated JPEG data");
    for (Component& c : comps_) {
      if (lossless_) {
        c.plane.assign((size_t)c.bw * 8 * c.bh * 8, 0);
        continue;
      }
      c.coef.assign((size_t)c.pw * c.ph * 64, 0);
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
  }

  void read_dht(const uint8_t* s, size_t sl) {
    size_t i = 0;
    while (i < sl) {
      if (i + 17 > sl) fail("bad DHT marker length");
      const int idx = s[i];
      HuffSpec spec;
      spec.defined = true;
      int count = 0;
      for (int l = 1; l <= 16; l++) count += spec.bits[l] = s[i + l];
      i += 17;
      if (count > 256 || i + count > sl) fail("bad Huffman table");
      memcpy(spec.vals, s + i, count);
      i += count;
      const int cls = idx >> 4, th = idx & 15;
      if (cls > 1 || th > 3) fail("bad DHT table index 0x%02x", idx);
      (cls ? ac_spec_ : dc_spec_)[th] = spec;
    }
  }

  void read_dqt(const uint8_t* s, size_t sl) {
    size_t i = 0;
    while (i < sl) {
      const int prec = s[i] >> 4, tq = s[i] & 15;
      if (tq > 3) fail("bad DQT table number %d", tq);
      i++;
      const size_t need = prec ? 128 : 64;
      if (i + need > sl) fail("bad DQT marker length");
      for (int k = 0; k < 64; k++)
        qt_[tq][kNatural[k]] =
            prec ? (uint16_t)((s[i + 2 * k] << 8) | s[i + 2 * k + 1])
                 : s[i + k];
      qt_defined_[tq] = true;
      i += need;
    }
  }

  // DAC (get_dac): pairs of (Tc << 4 | Tb, value); DC values hold U in
  // the high and L in the low nibble, AC values Kx.
  void read_dac(const uint8_t* s, size_t sl) {
    if (sl % 2) fail("bad DAC marker length");
    for (size_t i = 0; i < sl; i += 2) {
      const int idx = s[i], val = s[i + 1];
      if (idx >= 32) fail("bad DAC table index 0x%02x", idx);
      if (idx >= 16) {
        dac_k_[idx - 16] = (uint8_t)val;
      } else {
        dac_l_[idx] = val & 15;
        dac_u_[idx] = val >> 4;
        if (dac_l_[idx] > dac_u_[idx]) fail("bad DAC value 0x%02x", val);
      }
    }
  }

  // ---------------------------------------------------------- bit reader
  void bits_start(size_t p) {
    pos_ = p;
    buf_ = 0;
    nbits_ = fake_ = 0;
    hit_ = false;
  }

  void fill() {
    while (nbits_ <= 56) {
      uint32_t c = 0;
      if (hit_ || pos_ >= n_) {
        if (!hit_) {
          hit_ = true;
          marker_at_ = n_;
        }
        fake_ += 8;
      } else if (d_[pos_] != 0xFF) {
        c = d_[pos_++];
      } else {
        size_t q = pos_ + 1;
        while (q < n_ && d_[q] == 0xFF) q++;
        if (q < n_ && d_[q] == 0) {
          c = 0xFF;
          pos_ = q + 1;
        } else {
          hit_ = true;
          marker_at_ = pos_;
          fake_ += 8;
        }
      }
      buf_ = (buf_ << 8) | c;
      nbits_ += 8;
    }
  }

  void consumed() {
    if (nbits_ < fake_)
      fail("corrupt JPEG data: premature end of data segment");
  }

  int get_bits(int n) {
    if (n == 0) return 0;
    if (nbits_ < n) fill();
    nbits_ -= n;
    consumed();
    return (int)((buf_ >> nbits_) & ((1u << n) - 1));
  }

  int decode(const Huff& h) {
    if (nbits_ < 16) fill();
    const uint16_t e = h.look[(buf_ >> (nbits_ - kLookBits)) &
                              ((1 << kLookBits) - 1)];
    if (e) {
      nbits_ -= e >> 8;
      consumed();
      return e & 0xFF;
    }
    int l = kLookBits + 1;
    int32_t code = (int32_t)((buf_ >> (nbits_ - l)) & ((1u << l) - 1));
    while (l <= 16 && code > h.maxcode[l]) {
      l++;
      code = (int32_t)((buf_ >> (nbits_ - l)) & ((1u << l) - 1));
    }
    if (l > 16) fail("corrupt JPEG data: bad Huffman code");
    nbits_ -= l;
    consumed();
    return h.vals[(code + h.valoffset[l]) & 0xFF];
  }

  static int extend(int x, int s) {
    return s && x < (1 << (s - 1)) ? x + (int)(~0u << s) + 1 : x;
  }

  // Position after the data of the current entropy-coded segment: at the
  // marker the reader stopped on, or where its bytes end.
  size_t segment_end() const { return hit_ ? marker_at_ : pos_; }

  // --------------------------------------------------- arithmetic decoder
  void arith_start(size_t p) {
    pos_ = p;
    hit_ = false;
    ac_c_ = ac_a_ = 0;
    ac_ct_ = -16;  // fetch two bytes into C first
  }

  // The next byte of entropy-coded data (FF 00 unstuffed), or 0 from the
  // marker on (jdarith.c's get_byte convention).  Data that ends with no
  // marker is a truncated file.
  int arith_byte() {
    if (hit_) return 0;
    if (pos_ >= n_) fail("corrupt JPEG data: premature end of data segment");
    const int b = d_[pos_];
    if (b != 0xFF) {
      pos_++;
      return b;
    }
    size_t q = pos_ + 1;
    while (q < n_ && d_[q] == 0xFF) q++;
    if (q >= n_) fail("corrupt JPEG data: premature end of data segment");
    if (d_[q] == 0) {
      pos_ = q + 1;
      return 0xFF;
    }
    hit_ = true;
    marker_at_ = pos_;
    return 0;
  }

  // D.2: one decision with the statistics bin *st (state index in bits
  // 0-6, MPS in bit 7): renormalisation and byte input (D.2.6), then
  // the decision and the estimate's update (D.2.4, D.2.5).
  int arith_decode(uint8_t* st) {
    while (ac_a_ < 0x8000) {
      if (--ac_ct_ < 0) {
        ac_c_ = (ac_c_ << 8) | arith_byte();
        if ((ac_ct_ += 8) < 0 && ++ac_ct_ == 0) ac_a_ = 0x8000;
      }
      ac_a_ <<= 1;
    }
    int sv = *st;
    const QeState& e = kQe[sv & 0x7F];
    const int64_t qe = e.qe;
    const uint8_t nl = (uint8_t)(e.nlps | e.sw << 7), nm = e.nmps;
    int64_t temp = ac_a_ - qe;
    ac_a_ = temp;
    temp <<= ac_ct_;
    if (ac_c_ >= temp) {
      ac_c_ -= temp;
      if (ac_a_ < qe) {  // conditional exchange: the MPS
        ac_a_ = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        ac_a_ = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (ac_a_ < 0x8000) {
      if (ac_a_ < qe) {  // conditional exchange: the LPS
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  [[noreturn]] static void bad_arith() {
    fail("corrupt JPEG data: bad arithmetic code");
  }

  // F.2.4.1: a DC difference with table `tbl`'s statistics at context
  // *ctx, which becomes the next context (F.1.4.4.1.2).
  int arith_dc_diff(int tbl, int* ctx) {
    uint8_t* dcs = dc_stats_[tbl];
    uint8_t* st = dcs + *ctx;
    if (arith_decode(st) == 0) {
      *ctx = 0;
      return 0;
    }
    const int sign = arith_decode(st + 1);
    st += 2 + sign;
    int m = arith_decode(st);
    if (m) {
      st = dcs + 20;
      while (arith_decode(st)) {
        if ((m <<= 1) == 0x8000) bad_arith();
        st++;
      }
    }
    if (m < (1 << dac_l_[tbl]) >> 1)
      *ctx = 0;
    else if (m > (1 << dac_u_[tbl]) >> 1)
      *ctx = 12 + sign * 4;
    else
      *ctx = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    return sign ? -v : v;
  }

  // F.2.4.2 / G.2: the AC coefficients ss..se of a block, each shifted
  // left by al.
  void arith_ac(int tbl, int16_t* blk, int ss, int se, int al) {
    uint8_t* acs = ac_stats_[tbl];
    for (int k = ss; k <= se; k++) {
      uint8_t* st = acs + 3 * (k - 1);
      if (arith_decode(st)) break;  // EOB
      while (arith_decode(st + 1) == 0) {
        st += 3;
        if (++k > se) bad_arith();
      }
      const int sign = arith_decode(&fixed_bin_);
      st += 2;
      int m = arith_decode(st);
      if (m && arith_decode(st)) {
        m <<= 1;
        st = acs + (k <= dac_k_[tbl] ? 189 : 217);
        while (arith_decode(st)) {
          if ((m <<= 1) == 0x8000) bad_arith();
          st++;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (arith_decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = (int16_t)(uint32_t)((uint32_t)v << al);
    }
  }

  // G.2's AC refinement (jdarith.c decode_mcu_AC_refine).
  void arith_ac_refine(int tbl, int16_t* blk, int ss, int se, int al) {
    uint8_t* acs = ac_stats_[tbl];
    const int p1 = 1 << al, m1 = (int)(~0u << al);
    int kex = se;  // the previous stages' end of block
    while (kex > 0 && blk[kNatural[kex]] == 0) kex--;
    for (int k = ss; k <= se; k++) {
      uint8_t* st = acs + 3 * (k - 1);
      if (k > kex && arith_decode(st)) break;  // EOB
      for (;;) {
        int16_t* co = blk + kNatural[k];
        if (*co) {  // nonzero before: a correction bit
          if (arith_decode(st + 2)) *co = (int16_t)(*co + (*co < 0 ? m1 : p1));
          break;
        }
        if (arith_decode(st + 1)) {  // newly nonzero
          *co = (int16_t)(arith_decode(&fixed_bin_) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) bad_arith();
      }
    }
  }

  // The statistics and predictions a scan starts with, and starts again
  // with at each restart (jdarith.c start_pass, process_restart).
  void arith_reset(const int* cs, int ns, int ss, int ah) {
    for (int i = 0; i < ns; i++) {
      const Component& c = comps_[cs[i]];
      if (!progressive_ || (ss == 0 && ah == 0))
        memset(dc_stats_[c.dc_tbl], 0, sizeof(dc_stats_[0]));
      if (!progressive_ || ss)
        memset(ac_stats_[c.ac_tbl], 0, sizeof(ac_stats_[0]));
      dc_ctx_[i] = 0;
    }
  }

  // --------------------------------------------------------------- scans
  size_t read_sos(const uint8_t* s, size_t sl, size_t p) {
    if (!sof_) fail("SOS marker before SOF");
    if (sl < 1) fail("bad SOS marker length");
    const int ns = s[0];
    if (ns < 1 || ns > 4 || sl != 4 + 2 * (size_t)ns)
      fail("bad SOS marker length");
    int cs[4];
    for (int i = 0; i < ns; i++) {
      int ci = -1;
      for (size_t k = 0; k < comps_.size(); k++)
        if (comps_[k].id == s[1 + 2 * i]) ci = (int)k;
      if (ci < 0) fail("bad component id %d in SOS", s[1 + 2 * i]);
      for (int j = 0; j < i; j++)
        if (cs[j] == ci) fail("duplicate component id in SOS");
      cs[i] = ci;
      comps_[ci].dc_tbl = s[2 + 2 * i] >> 4;
      comps_[ci].ac_tbl = s[2 + 2 * i] & 15;
      if (!arith_ && (comps_[ci].dc_tbl > 3 || comps_[ci].ac_tbl > 3))
        fail("bad Huffman table number in SOS");
    }
    const int ss = s[1 + 2 * ns], se = s[2 + 2 * ns];
    const int ah = s[3 + 2 * ns] >> 4, al = s[3 + 2 * ns] & 15;
    if (scans_ == 0) {
      choose_space();
      if (!arith_)
        for (int t = 0; t < 2; t++) {  // std_huff_tables
          if (!dc_spec_[t].defined) std_table(&dc_spec_[t], t, true);
          if (!ac_spec_[t].defined) std_table(&ac_spec_[t], t, false);
        }
    }
    if (lossless_) {
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= precision_)
        fail("bad lossless JPEG scan parameters");
      for (int i = 0; i < ns; i++)
        derive(dc_spec_[comps_[cs[i]].dc_tbl], 16, &dc_[comps_[cs[i]].dc_tbl]);
      decode_lossless_scan(cs, ns, ss, al, p);
      scans_++;
      return segment_end();
    }
    for (int i = 0; i < ns; i++) {  // latch_quant_tables
      Component& c = comps_[cs[i]];
      if (c.latched) continue;
      if (!qt_defined_[c.tq])
        fail("quantisation table %d not defined", c.tq);
      for (int k = 0; k < 64; k++) c.q[k] = (int16_t)qt_[c.tq][k];
      c.latched = true;
    }
    if (progressive_)
      check_progression(cs, ns, ss, se, ah, al);
    else if (ss != 0 || se != 63 || ah != 0 || al != 0)
      fail("bad sequential JPEG scan parameters");
    if (!arith_)
      for (int i = 0; i < ns; i++) {
        Component& c = comps_[cs[i]];
        const bool dc_band = ss == 0;
        if (!progressive_ || (dc_band && ah == 0))
          derive(dc_spec_[c.dc_tbl], 15, &dc_[c.dc_tbl]);
        if (!progressive_ || !dc_band)
          derive(ac_spec_[c.ac_tbl], -1, &ac_[c.ac_tbl]);
      }
    decode_scan(cs, ns, ss, se, ah, al, p);
    scans_++;
    return segment_end();
  }

  // default_decompress_parms' colour space, from the markers and ids
  // seen before the first scan.  Lossless mode converts no colour, so
  // only RGB and CMYK files read in colour.
  void choose_space() {
    const int nc = (int)comps_.size();
    if (nc == 1) {
      space_ = kGrey;
    } else if (nc == 3) {
      if (jfif_)
        space_ = kYCbCr;
      else if (adobe_)
        space_ = adobe_transform_ == 0 ? kRGB : kYCbCr;
      else
        space_ = comps_[0].id == 82 && comps_[1].id == 71 &&
                         comps_[2].id == 66
                     ? kRGB
                     : kYCbCr;
    } else {
      space_ = adobe_ && adobe_transform_ != 0 ? kYCCK : kCMYK;
    }
    if (lossless_ && space_ != kRGB && space_ != kCMYK)
      fail("lossless JPEG in %s is not supported (lossless mode converts "
           "no colour)", kSpaceName[space_]);
  }

  void std_table(HuffSpec* spec, int t, bool dc) {
    spec->defined = true;
    const uint8_t* bits = kStdBits[(dc ? 0 : 2) + t];
    int n = 0;
    for (int l = 1; l <= 16; l++) n += spec->bits[l] = bits[l];
    memcpy(spec->vals, dc ? kStdDcVals : t ? kStdAcChroma : kStdAcLuma, n);
  }

  void check_progression(const int* cs, int ns, int ss, int se, int ah,
                         int al) {
    bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
    if (ah != 0 && al != ah - 1) bad = true;
    if (al > 13) bad = true;
    if (bad) fail("bad progressive JPEG scan parameters");
    for (int i = 0; i < ns; i++) {
      int* bits = comps_[cs[i]].coef_bits;
      if (ss != 0 && bits[0] < 0) fail("bogus JPEG progression");
      for (int k = ss; k <= se; k++) {
        if (ah != (bits[k] < 0 ? 0 : bits[k]))
          fail("bogus JPEG progression");
        bits[k] = al;
      }
    }
  }

  // Starts the entropy decoder on the data at p, or after the restart
  // marker `expect` (>= 0) that ends the current segment.
  void segment_start(size_t p, int expect) {
    if (expect >= 0) {
      p = segment_end();
      const int m = next_marker(&p);
      if (m != 0xD0 + expect)
        fail("corrupt JPEG data: expected restart marker %d", expect);
    }
    if (arith_)
      arith_start(p);
    else
      bits_start(p);
  }

  void decode_scan(const int* cs, int ns, int ss, int se, int ah, int al,
                   size_t p) {
    int mx, my, nblocks = 0;
    if (ns == 1) {
      mx = comps_[cs[0]].bw;
      my = comps_[cs[0]].bh;
    } else {
      mx = mcux_;
      my = mcuy_;
      for (int i = 0; i < ns; i++)
        nblocks += comps_[cs[i]].h * comps_[cs[i]].v;
      if (nblocks > 10) fail("bad JPEG MCU size");
    }
    segment_start(p, -1);
    int pred[4] = {0, 0, 0, 0};
    if (arith_) arith_reset(cs, ns, ss, ah);
    eobrun_ = 0;
    int to_go = restart_interval_, next_rst = 0;
    const int total = mx * my;
    for (int m = 0; m < total; m++) {
      if (restart_interval_) {
        if (to_go == 0) {
          segment_start(0, next_rst);
          next_rst = (next_rst + 1) & 7;
          to_go = restart_interval_;
          pred[0] = pred[1] = pred[2] = pred[3] = 0;
          eobrun_ = 0;
          if (arith_) arith_reset(cs, ns, ss, ah);
        }
        to_go--;
      }
      const int ux = m % mx, uy = m / mx;
      if (ns == 1) {
        decode_block(comps_[cs[0]], comps_[cs[0]].block(uy, ux), 0, pred,
                     ss, se, ah, al);
        continue;
      }
      for (int i = 0; i < ns; i++) {
        Component& c = comps_[cs[i]];
        for (int y = 0; y < c.v; y++)
          for (int x = 0; x < c.h; x++)
            decode_block(c, c.block(uy * c.v + y, ux * c.h + x), i, pred,
                         ss, se, ah, al);
      }
    }
  }

  // One block of component c, the i-th of the scan (its prediction
  // pred[i] and, arithmetic-coded, its DC context).
  void decode_block(Component& c, int16_t* blk, int i, int* pred, int ss,
                    int se, int ah, int al) {
    if (arith_) {
      if (ss == 0 && (!progressive_ || ah == 0)) {  // F.2.4.1, G.2 DC first
        pred[i] = wadd(pred[i], arith_dc_diff(c.dc_tbl, &dc_ctx_[i]));
        blk[0] = (int16_t)(uint32_t)((uint32_t)pred[i] << al);
      } else if (ss == 0) {  // DC refinement
        if (arith_decode(&fixed_bin_)) blk[0] |= (int16_t)(1 << al);
      }
      if (!progressive_)
        arith_ac(c.ac_tbl, blk, 1, 63, 0);
      else if (ss && ah == 0)
        arith_ac(c.ac_tbl, blk, ss, se, al);
      else if (ss)
        arith_ac_refine(c.ac_tbl, blk, ss, se, al);
      return;
    }
    if (!progressive_) {
      int s = decode(dc_[c.dc_tbl]);
      s = extend(get_bits(s), s);
      pred[i] = wadd(pred[i], s);
      blk[0] = (int16_t)pred[i];
      const Huff& ac = ac_[c.ac_tbl];
      for (int k = 1; k < 64; k++) {
        const int rs = decode(ac);
        const int r = rs >> 4, sz = rs & 15;
        if (sz) {
          k += r;
          blk[kNatural[k]] = (int16_t)extend(get_bits(sz), sz);
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (ss == 0) {  // DC scans
      if (ah == 0) {
        int s = decode(dc_[c.dc_tbl]);
        s = extend(get_bits(s), s);
        pred[i] = wadd(pred[i], s);
        blk[0] = (int16_t)(uint32_t)((uint32_t)pred[i] << al);
      } else if (get_bits(1)) {
        blk[0] |= (int16_t)(1 << al);
      }
      return;
    }
    const Huff& ac = ac_[c.ac_tbl];
    if (ah == 0) {  // AC first
      if (eobrun_ > 0) {
        eobrun_--;
        return;
      }
      for (int k = ss; k <= se; k++) {
        const int rs = decode(ac);
        int r = rs >> 4;
        const int sz = rs & 15;
        if (sz) {
          k += r;
          const int v = extend(get_bits(sz), sz);
          blk[kNatural[k]] = (int16_t)(uint32_t)((uint32_t)v << al);
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun_ = 1 << r;
          if (r) eobrun_ += get_bits(r);
          eobrun_--;
          break;
        }
      }
      return;
    }
    // AC refinement (jdphuff.c decode_mcu_AC_refine)
    const int p1 = 1 << al, m1 = (int)(~0u << al);
    int k = ss;
    if (eobrun_ == 0) {
      for (; k <= se; k++) {
        const int rs = decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) fail("corrupt JPEG data: bad Huffman code");
          s = get_bits(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun_ = 1 << r;
          if (r) eobrun_ += get_bits(r);
          break;
        }
        do {
          int16_t* co = blk + kNatural[k];
          if (*co != 0) {
            if (get_bits(1) && (*co & p1) == 0)
              *co = (int16_t)(*co + (*co >= 0 ? p1 : m1));
          } else if (--r < 0) {
            break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se; k++) {
        int16_t* co = blk + kNatural[k];
        if (*co != 0 && get_bits(1) && (*co & p1) == 0)
          *co = (int16_t)(*co + (*co >= 0 ? p1 : m1));
      }
      eobrun_--;
    }
  }

  // ------------------------------------------------------------ lossless
  // A lossless scan as jddiffct.c runs it: per iMCU row (one MCU row of
  // an interleaved scan; v sample rows of a component's own scan) the
  // differences of every MCU row, a restart marker before an MCU row
  // when the interval's rows are done; then each component's rows of
  // the iMCU row undifferenced (H.1.2.1) and written to its plane as
  // (value << Pt) & 255.
  void decode_lossless_scan(const int* cs, int ns, int psv, int pt,
                            size_t p) {
    int per_row, blocks = 0;
    if (ns == 1) {
      per_row = comps_[cs[0]].dw;
    } else {
      per_row = mcux_;
      for (int i = 0; i < ns; i++)
        blocks += comps_[cs[i]].h * comps_[cs[i]].v;
      if (blocks > 10) fail("bad JPEG MCU size");
    }
    if (restart_interval_ % per_row)
      fail("lossless JPEG restart interval %d is not whole MCU rows of %d",
           restart_interval_, per_row);
    const int interval_rows = restart_interval_ / per_row;
    int rows_to_go = interval_rows, next_rst = 0;
    bool first[4];
    for (int i = 0; i < ns; i++) {
      Component& c = comps_[cs[i]];
      c.diff.assign((size_t)c.v * per_row * (ns == 1 ? 1 : c.h), 0);
      c.prev.assign(c.dw, 0);
      first[i] = true;
    }
    segment_start(p, -1);
    for (int imcu = 0; imcu < mcuy_; imcu++) {
      const int mcu_rows = ns > 1 ? 1
          : imcu < mcuy_ - 1 ? comps_[cs[0]].v
          : comps_[cs[0]].dh - imcu * comps_[cs[0]].v;
      for (int y = 0; y < mcu_rows; y++) {
        if (restart_interval_) {
          if (rows_to_go == 0) {
            segment_start(0, next_rst);
            next_rst = (next_rst + 1) & 7;
            rows_to_go = interval_rows;
            for (int i = 0; i < ns; i++) first[i] = true;
          }
          rows_to_go--;
        }
        for (int mx = 0; mx < per_row; mx++)
          for (int i = 0; i < ns; i++) {
            Component& c = comps_[cs[i]];
            const int v = ns == 1 ? 1 : c.v, h = ns == 1 ? 1 : c.h;
            const int w = per_row * h;
            for (int yy = 0; yy < v; yy++)
              for (int xx = 0; xx < h; xx++)
                c.diff[(size_t)(y + yy) * w + mx * h + xx] =
                    lossless_diff(dc_[c.dc_tbl]);
          }
      }
      for (int i = 0; i < ns; i++) {
        Component& c = comps_[cs[i]];
        const int w = per_row * (ns == 1 ? 1 : c.h);
        const int r0 = imcu * c.v;
        const int rows = r0 + c.v <= c.dh ? c.v : c.dh - r0;
        for (int r = 0; r < rows; r++) {
          undifference(c, &c.diff[(size_t)r * w], psv, pt, first[i]);
          first[i] = false;
          uint8_t* out = &c.plane[(size_t)(r0 + r) * c.bw * 8];
          for (int x = 0; x < c.dw; x++)
            out[x] = (uint8_t)((uint32_t)c.prev[x] << pt);
        }
      }
    }
  }

  // H.2.2: a sample difference; category 16 is 32768 with no bits.
  int lossless_diff(const Huff& h) {
    const int s = decode(h);
    if (s == 16) return 32768;
    return extend(get_bits(s), s);
  }

  // One row of differences into c.prev (which holds the row above):
  // 1-D from 2^(P - Pt - 1) when `first`, else the first sample from
  // above and the rest with predictor psv, modulo 2^16.
  void undifference(Component& c, const int32_t* diff, int psv, int pt,
                    bool first) {
    int32_t* row = c.prev.data();
    const int w = c.dw;
    if (first) {
      int32_t ra = (diff[0] + (1 << (precision_ - pt - 1))) & 0xFFFF;
      row[0] = ra;
      for (int x = 1; x < w; x++) row[x] = ra = (diff[x] + ra) & 0xFFFF;
      return;
    }
    int32_t rb = row[0], ra = (diff[0] + rb) & 0xFFFF, rc;
    row[0] = ra;
    for (int x = 1; x < w; x++) {
      rc = rb;
      rb = row[x];
      int32_t pred;
      switch (psv) {
        case 1: pred = ra; break;
        case 2: pred = rb; break;
        case 3: pred = rc; break;
        case 4: pred = ra + rb - rc; break;
        case 5: pred = ra + ((rb - rc) >> 1); break;
        case 6: pred = rb + ((ra - rc) >> 1); break;
        default: pred = (ra + rb) >> 1; break;
      }
      row[x] = ra = (diff[x] + pred) & 0xFFFF;
    }
  }

  // The orientation of an Exif APP1 as OpenCV reads it: the TIFF header
  // after "Exif\0\0", IFD0's first 0x0112 entry, its 16-bit value (0
  // unless 1-8).  Returns false, to try the next Exif APP1, when the
  // header or IFD0 is malformed or empty.
  static bool exif_orientation(const uint8_t* t, size_t n, int* orientation) {
    if (n < 8) return false;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return false;
    auto u16 = [&](size_t o) -> int {
      return le ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1];
    };
    if (u16(2) != 0x2A) return false;
    const size_t ifd = le ? (size_t)t[4] | ((size_t)t[5] << 8) |
                                ((size_t)t[6] << 16) | ((size_t)t[7] << 24)
                          : ((size_t)t[4] << 24) | ((size_t)t[5] << 16) |
                                ((size_t)t[6] << 8) | (size_t)t[7];
    if (ifd + 2 > n) return false;
    const int count = u16(ifd);
    if (count == 0 || ifd + 2 + 12 * (size_t)count > n) return false;
    *orientation = 0;
    for (int i = 0; i < count; i++) {
      const size_t e = ifd + 2 + 12 * (size_t)i;
      if (u16(e) == 0x0112) {
        const int o = u16(e + 8);
        *orientation = o >= 1 && o <= 8 ? o : 0;
        break;
      }
    }
    return true;
  }

  // -------------------------------------------------------------- output
  void output() {
    if (progressive_)
      for (const Component& c : comps_)  // libjpeg would smooth blocks
        for (int k = 0; k < 10; k++)
          if (c.coef_bits[k] != 0)
            fail("incomplete progressive JPEG data");
    if (!lossless_)
      for (Component& c : comps_) {
        const int stride = c.bw * 8;
        c.plane.assign((size_t)stride * c.bh * 8, 0);
        for (int r = 0; r < c.bh; r++)
          for (int b = 0; b < c.bw; b++)
            idct_block(c.block(r, b), c.q,
                       &c.plane[(size_t)r * 8 * stride + b * 8], stride);
      }
    const size_t npx = (size_t)W * H;
    std::vector<uint8_t> full[4];
    for (size_t i = 0; i < comps_.size(); i++) {
      full[i].resize(npx);
      upsample(comps_[i], full[i].data());
    }
    rgb.resize(npx * 3);
    uint8_t* o = rgb.data();
    if (space_ == kGrey) {
      for (size_t i = 0; i < npx; i++)
        o[3 * i] = o[3 * i + 1] = o[3 * i + 2] = full[0][i];
      return;
    }
    if (space_ == kRGB) {
      for (size_t i = 0; i < npx; i++)
        for (int k = 0; k < 3; k++) o[3 * i + k] = full[k][i];
      return;
    }
    int cr_r[256], cb_b[256];
    int32_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; i++) {  // build_ycc_rgb_table
      const int64_t x = i - 128;
      cr_r[i] = (int)((91881 * x + 32768) >> 16);
      cb_b[i] = (int)((116130 * x + 32768) >> 16);
      cr_g[i] = (int32_t)(-46802 * x);
      cb_g[i] = (int32_t)(-22554 * x + 32768);
    }
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    const uint8_t *Y = full[0].data(), *Cb = full[1].data(),
                  *Cr = full[2].data(), *K = full[3].data();
    if (space_ == kYCbCr) {
      for (size_t i = 0; i < npx; i++) {
        const int y = Y[i], cb = Cb[i], cr = Cr[i];
        o[3 * i] = clamp(y + cr_r[cr]);
        o[3 * i + 1] = clamp(y + ((cb_g[cb] + cr_g[cr]) >> 16));
        o[3 * i + 2] = clamp(y + cb_b[cb]);
      }
      return;
    }
    // CMYK (YCCK first made CMYK by ycck_cmyk_convert), then OpenCV's
    // CMYK -> BGR
    auto ink = [](int v, int k) { return (uint8_t)(k - ((255 - v) * k >> 8)); };
    for (size_t i = 0; i < npx; i++) {
      int c = Y[i], m = Cb[i], y = Cr[i];
      const int k = K[i];
      if (space_ == kYCCK) {
        const int l = Y[i], cb = Cb[i], cr = Cr[i];
        c = clamp(255 - (l + cr_r[cr]));
        m = clamp(255 - (l + ((cb_g[cb] + cr_g[cr]) >> 16)));
        y = clamp(255 - (l + cb_b[cb]));
      }
      o[3 * i] = ink(c, k);
      o[3 * i + 1] = ink(m, k);
      o[3 * i + 2] = ink(y, k);
    }
  }

  // One component at full size (H rows of W samples) from its plane,
  // with the method jinit_upsampler picks (no fancy filters in lossless
  // mode, whose data units are single samples).
  void upsample(const Component& c, uint8_t* out) const {
    const int stride = c.bw * 8;
    const uint8_t* in = c.plane.data();
    auto row = [&](int r) {
      return in + (size_t)(r < 0 ? 0 : r >= c.dh ? c.dh - 1 : r) * stride;
    };
    const int hi = c.h, ho = max_h_, vi = c.v, vo = max_v_;
    if (hi == ho && vi == vo) {
      for (int y = 0; y < H; y++) memcpy(out + (size_t)y * W, row(y), W);
      return;
    }
    const bool fancy = !lossless_;
    std::vector<uint8_t> tmp(2 * (size_t)c.dw + 2);
    if (fancy && hi * 2 == ho && vi == vo && c.dw > 2) {  // h2v1 fancy
      for (int y = 0; y < H; y++) {
        const uint8_t* s = row(y);
        uint8_t* o = tmp.data();
        const int n = c.dw;
        o[0] = s[0];
        o[1] = (uint8_t)((s[0] * 3 + s[1] + 2) >> 2);
        for (int x = 1; x < n - 1; x++) {
          const int v = s[x] * 3;
          o[2 * x] = (uint8_t)((v + s[x - 1] + 1) >> 2);
          o[2 * x + 1] = (uint8_t)((v + s[x + 1] + 2) >> 2);
        }
        o[2 * n - 2] = (uint8_t)((s[n - 1] * 3 + s[n - 2] + 1) >> 2);
        o[2 * n - 1] = s[n - 1];
        memcpy(out + (size_t)y * W, o, W);
      }
      return;
    }
    if (fancy && hi == ho && vi * 2 == vo) {  // h1v2 fancy
      for (int y = 0; y < H; y++) {
        const int r = y >> 1;
        const uint8_t* s0 = row(r);
        const uint8_t* s1 = row(y & 1 ? r + 1 : r - 1);
        const int bias = y & 1 ? 2 : 1;
        uint8_t* o = out + (size_t)y * W;
        for (int x = 0; x < W; x++)
          o[x] = (uint8_t)((s0[x] * 3 + s1[x] + bias) >> 2);
      }
      return;
    }
    if (fancy && hi * 2 == ho && vi * 2 == vo && c.dw > 2) {  // h2v2 fancy
      std::vector<int> sum(c.dw);
      for (int y = 0; y < H; y++) {
        const int r = y >> 1;
        const uint8_t* s0 = row(r);
        const uint8_t* s1 = row(y & 1 ? r + 1 : r - 1);
        const int n = c.dw;
        for (int x = 0; x < n; x++) sum[x] = s0[x] * 3 + s1[x];
        uint8_t* o = tmp.data();
        o[0] = (uint8_t)((sum[0] * 4 + 8) >> 4);
        o[1] = (uint8_t)((sum[0] * 3 + sum[1] + 7) >> 4);
        for (int x = 1; x < n - 1; x++) {
          o[2 * x] = (uint8_t)((sum[x] * 3 + sum[x - 1] + 8) >> 4);
          o[2 * x + 1] = (uint8_t)((sum[x] * 3 + sum[x + 1] + 7) >> 4);
        }
        o[2 * n - 2] = (uint8_t)((sum[n - 1] * 3 + sum[n - 2] + 8) >> 4);
        o[2 * n - 1] = (uint8_t)((sum[n - 1] * 4 + 7) >> 4);
        memcpy(out + (size_t)y * W, o, W);
      }
      return;
    }
    if (ho % hi || vo % vi)
      fail("fractional JPEG sampling ratios are not supported");
    const int fx = ho / hi, fy = vo / vi;  // int_upsample, h2v1, h2v2
    for (int y = 0; y < H; y++) {
      const uint8_t* s = in + (size_t)(y / fy) * stride;
      uint8_t* o = out + (size_t)y * W;
      for (int x = 0; x < W; x++) o[x] = s[x / fx];
    }
  }

  const uint8_t* d_;
  size_t n_;
  bool sof_ = false, progressive_ = false, arith_ = false, lossless_ = false;
  bool jfif_ = false, adobe_ = false, exif_ = false;
  int adobe_transform_ = 0, precision_ = 8;
  Space space_ = kGrey;
  int scans_ = 0, restart_interval_ = 0;
  int max_h_ = 1, max_v_ = 1, mcux_ = 0, mcuy_ = 0;
  std::vector<Component> comps_;
  uint16_t qt_[4][64] = {};
  bool qt_defined_[4] = {};
  HuffSpec dc_spec_[4], ac_spec_[4];
  Huff dc_[4], ac_[4];
  int eobrun_ = 0;
  // bit reader state (the arithmetic decoder shares pos_, hit_ and
  // marker_at_)
  size_t pos_ = 0, marker_at_ = 0;
  uint64_t buf_ = 0;
  int nbits_ = 0, fake_ = 0;
  bool hit_ = false;
  // arithmetic decoder: C and A registers, bit counter, statistics
  // areas and DAC conditioning per table (T.81's defaults L 0, U 1,
  // Kx 5), the scan's DC contexts, the fixed 0.5 bin
  int64_t ac_c_ = 0, ac_a_ = 0;
  int ac_ct_ = 0;
  uint8_t dc_stats_[16][64] = {}, ac_stats_[16][256] = {};
  uint8_t dac_l_[16] = {}, dac_u_[16] = {1, 1, 1, 1, 1, 1, 1, 1,
                                         1, 1, 1, 1, 1, 1, 1, 1};
  uint8_t dac_k_[16] = {5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5};
  int dc_ctx_[4] = {};
  uint8_t fixed_bin_ = kFixedBin;
};

}  // namespace

extern "C" {

// Decodes n bytes of JPEG data.  On success returns 0 and sets *out to a
// malloc'd H*W*3 RGB buffer (free with mn_jpeg_free), *h, *w and
// *orientation; on failure returns 1 with the cause in err.
int mn_jpeg_decode(const uint8_t* data, size_t n, uint8_t** out, int* h,
                   int* w, int* orientation, char* err, int errlen) {
  *out = nullptr;
  try {
    Decoder dec(data, n);
    dec.run();
    uint8_t* buf = (uint8_t*)malloc(dec.rgb.size());
    if (!buf) fail("out of memory");
    memcpy(buf, dec.rgb.data(), dec.rgb.size());
    *out = buf;
    *h = dec.H;
    *w = dec.W;
    *orientation = dec.orientation_;
    return 0;
  } catch (const JpegError& e) {
    snprintf(err, errlen, "%s", e.msg.c_str());
  } catch (const std::exception& e) {  // allocation failures
    snprintf(err, errlen, "%s", e.what());
  }
  return 1;
}

void mn_jpeg_free(uint8_t* p) { free(p); }

}  // extern "C"

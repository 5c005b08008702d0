// The port's WebP bitstream decoders (`data/webp.py` walks the RIFF
// container and makes every choice cv2 makes): VP8L (lossless, RFC
// 9649), VP8 key frames (lossy, RFC 6386) with libwebp's output stage,
// and ALPH chunks.  Written for the port; no libwebp is vendored or
// linked.  The results are bit for bit those of libwebp's decoder
// (WebPDecodeBGRInto, the call cv2's WebP decoder makes), so the code
// follows libwebp's computations wherever the format leaves a choice:
//
// - VP8: the boolean decoder (its range kept minus one, the sign read
//   at half range), the token tree and contexts, dequantisation with
//   the y2 AC factor (x * 101581) >> 16 and a floor of 8, the WHT, the
//   inverse DCT with 20091/35468 multipliers, intra prediction from
//   unfiltered neighbours (127 above the frame, 129 left of it), the
//   simple and normal loop filters on 16-pixel macroblocks in raster
//   order, inner edges only for i4x4 or coded macroblocks; a frame
//   whose global filter level is 0 is not filtered at all;
// - output: libwebp's "fancy" upsampling of the 4:2:0 chroma (each
//   output pixel 9:3:3:1 of its four nearest chroma samples, rounded in
//   two steps, the frame's edge samples mirrored) and YUV to RGB with
//   libwebp's 14-bit fixed-point constants (src/dsp/yuv.h: VP8YUVToR/G/B);
// - VP8L: the prefix codes (a single used symbol is a code of no bits,
//   any other code must be complete), meta codes, the colour cache,
//   LZ77 with the 120 plane codes, and the four inverse transforms;
// - ALPH: raw or VP8L-compressed alpha, then un-filtered (none,
//   horizontal, vertical, gradient).
//
// Truncated and corrupt data raise: a boolean decoder that needs a byte
// past its partition, a VP8L reader past its data, a copy before the
// first pixel or past the last, a code that does not decode.  Plain C
// interface, loaded with ctypes.

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct WebpError {
  std::string msg;
};

[[noreturn]] void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof(buf), fmt, ap);
  va_end(ap);
  throw WebpError{buf};
}

// RFC 6386 13.5: default token probabilities [type][band][ctx][11]
static const uint8_t kCoeffsProba0[4][8][3][11] = {
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
  189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
  106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
  1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
  181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
  78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
  1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
  184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
  77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
  1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
  170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
  37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
  1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
  207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
  102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
  1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
  177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
  80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
  1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
  131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
  68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
  1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
  184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
  81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
  1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
  99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
  23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
  1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
  109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
  44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
  1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
  94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
  22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
  1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
  124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
  35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
  1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
  121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
  45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
  1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
  203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
  253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
  175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
  73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
  1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
  239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
  155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
  1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
  201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
  69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
  1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
  223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
  141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
  149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
  213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
  55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
  126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
  61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
  1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
  166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
  39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
  1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
  124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
  24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
  1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
  149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
  28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
  1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
  123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
  20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
  1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
  168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
  47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
  1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
  141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
  42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
  1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

// RFC 6386 13.4: token probability update probabilities
static const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
  250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
  234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
  255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
  234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
  251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
  255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
  248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
  255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
  255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

// RFC 6386 11.5: key-frame sub-block mode probabilities [top][left][9],
// modes in the order B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU
static const uint8_t kBModesProba[10][10][9] = {
  231, 120, 48, 89, 115, 113, 120, 152, 112,
  152, 179, 64, 126, 170, 118, 46, 70, 95,
  175, 69, 143, 80, 85, 82, 72, 155, 103,
  56, 58, 10, 171, 218, 189, 17, 13, 152,
  114, 26, 17, 163, 44, 195, 21, 10, 173,
  121, 24, 80, 195, 26, 62, 44, 64, 85,
  144, 71, 10, 38, 171, 213, 144, 34, 26,
  170, 46, 55, 19, 136, 160, 33, 206, 71,
  63, 20, 8, 114, 114, 208, 12, 9, 226,
  81, 40, 11, 96, 182, 84, 29, 16, 36,
  134, 183, 89, 137, 98, 101, 106, 165, 148,
  72, 187, 100, 130, 157, 111, 32, 75, 80,
  66, 102, 167, 99, 74, 62, 40, 234, 128,
  41, 53, 9, 178, 241, 141, 26, 8, 107,
  74, 43, 26, 146, 73, 166, 49, 23, 157,
  65, 38, 105, 160, 51, 52, 31, 115, 128,
  104, 79, 12, 27, 217, 255, 87, 17, 7,
  87, 68, 71, 44, 114, 51, 15, 186, 23,
  47, 41, 14, 110, 182, 183, 21, 17, 194,
  66, 45, 25, 102, 197, 189, 23, 18, 22,
  88, 88, 147, 150, 42, 46, 45, 196, 205,
  43, 97, 183, 117, 85, 38, 35, 179, 61,
  39, 53, 200, 87, 26, 21, 43, 232, 171,
  56, 34, 51, 104, 114, 102, 29, 93, 77,
  39, 28, 85, 171, 58, 165, 90, 98, 64,
  34, 22, 116, 206, 23, 34, 43, 166, 73,
  107, 54, 32, 26, 51, 1, 81, 43, 31,
  68, 25, 106, 22, 64, 171, 36, 225, 114,
  34, 19, 21, 102, 132, 188, 16, 76, 124,
  62, 18, 78, 95, 85, 57, 50, 48, 51,
  193, 101, 35, 159, 215, 111, 89, 46, 111,
  60, 148, 31, 172, 219, 228, 21, 18, 111,
  112, 113, 77, 85, 179, 255, 38, 120, 114,
  40, 42, 1, 196, 245, 209, 10, 25, 109,
  88, 43, 29, 140, 166, 213, 37, 43, 154,
  61, 63, 30, 155, 67, 45, 68, 1, 209,
  100, 80, 8, 43, 154, 1, 51, 26, 71,
  142, 78, 78, 16, 255, 128, 34, 197, 171,
  41, 40, 5, 102, 211, 183, 4, 1, 221,
  51, 50, 17, 168, 209, 192, 23, 25, 82,
  138, 31, 36, 171, 27, 166, 38, 44, 229,
  67, 87, 58, 169, 82, 115, 26, 59, 179,
  63, 59, 90, 180, 59, 166, 93, 73, 154,
  40, 40, 21, 116, 143, 209, 34, 39, 175,
  47, 15, 16, 183, 34, 223, 49, 45, 183,
  46, 17, 33, 183, 6, 98, 15, 32, 183,
  57, 46, 22, 24, 128, 1, 54, 17, 37,
  65, 32, 73, 115, 28, 128, 23, 128, 205,
  40, 3, 9, 115, 51, 192, 18, 6, 223,
  87, 37, 9, 115, 59, 77, 64, 21, 47,
  104, 55, 44, 218, 9, 54, 53, 130, 226,
  64, 90, 70, 205, 40, 41, 23, 26, 57,
  54, 57, 112, 184, 5, 41, 38, 166, 213,
  30, 34, 26, 133, 152, 116, 10, 32, 134,
  39, 19, 53, 221, 26, 114, 32, 73, 255,
  31, 9, 65, 234, 2, 15, 1, 118, 73,
  75, 32, 12, 51, 192, 255, 160, 43, 51,
  88, 31, 35, 67, 102, 85, 55, 186, 85,
  56, 21, 23, 111, 59, 205, 45, 37, 192,
  55, 38, 70, 124, 73, 102, 1, 34, 98,
  125, 98, 42, 88, 104, 85, 117, 175, 82,
  95, 84, 53, 89, 128, 100, 113, 101, 45,
  75, 79, 123, 47, 51, 128, 81, 171, 1,
  57, 17, 5, 71, 102, 57, 53, 41, 49,
  38, 33, 13, 121, 57, 73, 26, 1, 85,
  41, 10, 67, 138, 77, 110, 90, 47, 114,
  115, 21, 2, 10, 102, 255, 166, 23, 6,
  101, 29, 16, 10, 85, 128, 101, 196, 26,
  57, 18, 10, 102, 102, 213, 34, 20, 43,
  117, 20, 15, 36, 163, 128, 68, 1, 26,
  102, 61, 71, 37, 34, 53, 31, 243, 192,
  69, 60, 71, 38, 73, 119, 28, 222, 37,
  68, 45, 128, 34, 1, 47, 11, 245, 171,
  62, 17, 19, 70, 146, 85, 55, 62, 70,
  37, 43, 37, 154, 100, 163, 85, 160, 1,
  63, 9, 92, 136, 28, 64, 32, 201, 85,
  75, 15, 9, 9, 64, 255, 184, 119, 16,
  86, 6, 28, 5, 64, 255, 25, 248, 1,
  56, 8, 17, 132, 137, 255, 55, 116, 128,
  58, 15, 20, 82, 135, 57, 26, 121, 40,
  164, 50, 31, 137, 154, 133, 25, 35, 218,
  51, 103, 44, 131, 131, 123, 31, 6, 158,
  86, 40, 64, 135, 148, 224, 45, 183, 128,
  22, 26, 17, 131, 240, 154, 14, 1, 209,
  45, 16, 21, 91, 64, 222, 7, 1, 197,
  56, 21, 39, 155, 60, 138, 23, 102, 213,
  83, 12, 13, 54, 192, 255, 68, 47, 28,
  85, 26, 85, 85, 128, 128, 32, 146, 171,
  18, 11, 7, 63, 144, 171, 4, 4, 246,
  35, 27, 10, 146, 174, 171, 12, 26, 128,
  190, 80, 35, 99, 180, 80, 126, 54, 45,
  85, 126, 47, 87, 176, 51, 41, 20, 32,
  101, 75, 128, 139, 118, 146, 116, 128, 85,
  56, 41, 15, 176, 236, 85, 37, 9, 62,
  71, 30, 17, 119, 118, 255, 17, 18, 138,
  101, 38, 60, 138, 55, 70, 43, 26, 142,
  146, 36, 19, 30, 171, 255, 97, 27, 20,
  138, 45, 61, 62, 219, 1, 81, 188, 64,
  32, 41, 20, 117, 151, 142, 20, 21, 163,
  112, 19, 12, 61, 195, 128, 48, 4, 24,
};

// RFC 6386 14.1: dequantisation tables
static const uint8_t kDcTable[128] = {
  4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
  18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
  29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
  44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
  59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
  75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
  91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
  122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

static const uint16_t kAcTable[128] = {
  4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
  20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
  36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
  52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
  78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
  110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
  155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
  213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

// RFC 9649 5.2.2: the 120 short distance codes, (dy << 4) | (8 - dx)
static const uint8_t kCodeToPlane[120] = {
  24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
  56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
  71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
  75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
  68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
  102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
  120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
  118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
  0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
  81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};
// ------------------------------------------------------------------ VP8L

// LSB-first bit reader.  Bits past the data read as zeros, as libwebp's
// do; libwebp flags the end of the stream once more bits were taken than
// the data holds (at least 64: a stream shorter than 8 bytes may read
// zeros up to 64 bits) and the decode then fails, so `over` is checked
// after each part.
struct LBits {
  const uint8_t* d;
  size_t n, pos = 0;
  uint64_t val = 0, taken = 0, limit;
  int nbits = 0;
  LBits(const uint8_t* data, size_t size)
      : d(data), n(size), limit(8 * (uint64_t)(size < 8 ? 8 : size)) {}
  void fill() {
    while (nbits <= 56) {
      uint64_t b = pos < n ? d[pos] : 0;
      ++pos;
      val |= b << nbits;
      nbits += 8;
    }
  }
  uint32_t peek(int k) {
    if (nbits < k) fill();
    return (uint32_t)(val & ((1ull << k) - 1));
  }
  void skip(int k) {
    val >>= k;
    nbits -= k;
    taken += k;
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return v;
  }
  bool over() const { return taken > limit; }
};

struct HC {
  uint8_t bits;
  uint16_t value;
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                  7,  8,  9, 10, 11, 12, 13, 14, 15};
const int kAlphabetSize[5] = {256 + 24, 256, 256, 256, 40};
enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
const int kRootBits = 8;

void replicate(HC* table, int step, int end, HC code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}

uint32_t next_key(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

int next_table_bits(const int* count, int len, int root_bits) {
  int left = 1 << (len - root_bits);
  while (len < 15) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - root_bits;
}

// Canonical prefix code of code lengths `lens` as libwebp's
// BuildHuffmanTable builds and checks it: a root table of `root_bits`
// and second-level tables after it, appended to `out` (which may be
// null: the code is then only checked).  Returns the root's index; fails
// on a code with no symbol or one that is over-full or incomplete (one
// symbol alone is a code of no bits).
size_t build_code(std::vector<HC>* out, int root_bits, const int* lens,
                  int n) {
  int count[16] = {0}, offset[16];
  for (int s = 0; s < n; ++s) ++count[lens[s]];
  if (count[0] == n) fail("VP8L: a prefix code without symbols");
  offset[1] = 0;
  for (int len = 1; len < 15; ++len) {
    if (count[len] > (1 << len)) fail("VP8L: an over-full prefix code");
    offset[len + 1] = offset[len] + count[len];
  }
  std::vector<uint16_t> sorted(n);
  for (int s = 0; s < n; ++s)
    if (lens[s] > 0) sorted[offset[lens[s]]++] = (uint16_t)s;
  size_t base = out ? out->size() : 0;
  int total = 1 << root_bits;
  if (out) out->resize(base + total);
  if (offset[15] == 1) {
    if (out) replicate(out->data() + base, 1, total, HC{0, sorted[0]});
    return base;
  }
  int step, sym = 0, num_nodes = 1, num_open = 1;
  uint32_t key = 0, low = 0xffffffffu, mask = total - 1;
  size_t table = base;
  int table_size = total;
  int len;
  for (len = 1, step = 2; len <= root_bits; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) fail("VP8L: an over-full prefix code");
    if (!out) continue;
    for (; count[len] > 0; --count[len]) {
      replicate(out->data() + table + key, step, table_size,
                HC{(uint8_t)len, sorted[sym++]});
      key = next_key(key, len);
    }
  }
  for (len = root_bits + 1, step = 2; len <= 15; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) fail("VP8L: an over-full prefix code");
    if (!out) continue;
    for (; count[len] > 0; --count[len]) {
      if ((key & mask) != low) {
        table += table_size;
        int table_bits = next_table_bits(count, len, root_bits);
        table_size = 1 << table_bits;
        total += table_size;
        out->resize(base + total);
        low = key & mask;
        (*out)[base + low] = HC{(uint8_t)(table_bits + root_bits),
                                (uint16_t)(table - base - low)};
      }
      replicate(out->data() + table + (key >> root_bits), step, table_size,
                HC{(uint8_t)(len - root_bits), sorted[sym++]});
      key = next_key(key, len);
    }
  }
  if (num_nodes != 2 * offset[15] - 1)
    fail("VP8L: an incomplete prefix code");
  return base;
}

struct Group {
  size_t code[5];
};

struct Codes {
  std::vector<HC> tables;
  std::vector<Group> groups;
  std::vector<uint32_t> image;  // group per tile
  int bits = 0, xsize = 0;
};

struct Transform {
  int type, bits, xsize;
  std::vector<uint32_t> data;
};

uint32_t subsample(uint32_t size, int bits) {
  return (size + (1u << bits) - 1) >> bits;
}

struct VP8L {
  LBits br;
  Transform tr[4];
  int ntr = 0;
  unsigned seen = 0;

  VP8L(const uint8_t* d, size_t n) : br(d, n) {}

  void check() {
    if (br.over()) fail("VP8L data ends early");
  }

  int symbol(const std::vector<HC>& tables, size_t root) {
    uint32_t v = br.peek(15);
    const HC* t = tables.data() + root + (v & 0xff);
    int nbits = t->bits - kRootBits;
    if (nbits > 0) {
      br.skip(kRootBits);
      t += t->value + ((v >> kRootBits) & ((1u << nbits) - 1));
    }
    br.skip(t->bits);
    return t->value;
  }

  void code_lengths(const int* cl_lens, int n, int* lens) {
    std::vector<HC> table;
    build_code(&table, 7, cl_lens, 19);
    int max_symbol = n;
    if (br.read(1)) {
      int nbits = 2 + 2 * br.read(3);
      max_symbol = 2 + br.read(nbits);
      if (max_symbol > n) fail("VP8L: code lengths past the alphabet");
    }
    int prev = 8, s = 0;
    while (s < n) {
      if (max_symbol-- == 0) break;
      const HC& c = table[br.peek(7)];
      br.skip(c.bits);
      int len = c.value;
      if (len < 16) {
        lens[s++] = len;
        if (len) prev = len;
      } else {
        static const int extra[3] = {2, 3, 7}, off[3] = {3, 3, 11};
        int repeat = br.read(extra[len - 16]) + off[len - 16];
        if (s + repeat > n) fail("VP8L: code lengths past the alphabet");
        int v = len == 16 ? prev : 0;
        while (repeat-- > 0) lens[s++] = v;
      }
    }
  }

  // Reads one prefix code of `n` symbols; returns its root in `tables`
  // (or only checks it when tables is null).
  size_t read_code(int n, std::vector<HC>* tables) {
    std::vector<int> lens(n, 0);
    if (br.read(1)) {  // simple code: one or two symbols
      int nsym = br.read(1) + 1;
      int first8 = br.read(1);
      int s = br.read(first8 ? 8 : 1);
      if (s < n) lens[s] = 1;
      if (nsym == 2) {
        s = br.read(8);
        if (s < n) lens[s] = 1;
      }
    } else {
      int cl[19] = {0};
      int k = br.read(4) + 4;
      for (int i = 0; i < k; ++i) cl[kCodeLengthOrder[i]] = br.read(3);
      code_lengths(cl, n, lens.data());
    }
    check();
    return build_code(tables, kRootBits, lens.data(), n);
  }

  void read_codes(Codes& c, int xsize, int ysize, int cache_bits,
                  bool meta) {
    int ngroups = 1;
    std::vector<char> used(1, 1);
    if (meta && br.read(1)) {
      c.bits = br.read(3) + 2;
      c.xsize = subsample(xsize, c.bits);
      std::vector<uint32_t> img =
          stream(c.xsize, subsample(ysize, c.bits), false, nullptr);
      c.image.resize(img.size());
      for (size_t i = 0; i < img.size(); ++i) {
        int g = (img[i] >> 8) & 0xffff;
        c.image[i] = g;
        if (g >= ngroups) ngroups = g + 1;
      }
      used.assign(ngroups, 0);
      for (uint32_t g : c.image) used[g] = 1;
    }
    check();
    c.groups.resize(ngroups);
    for (int g = 0; g < ngroups; ++g)
      for (int j = 0; j < 5; ++j) {
        int n = kAlphabetSize[j] + (j == 0 && cache_bits ? 1 << cache_bits : 0);
        c.groups[g].code[j] = read_code(n, used[g] ? &c.tables : nullptr);
      }
  }

  void read_transform(int* xsize, int ysize) {
    int type = br.read(2);
    if (seen & (1u << type)) fail("VP8L: transform %d given twice", type);
    seen |= 1u << type;
    Transform& t = tr[ntr++];
    t.type = type;
    t.xsize = *xsize;
    t.bits = 0;
    if (type == 0 || type == 1) {  // predictor, cross-colour
      t.bits = br.read(3) + 2;
      t.data = stream(subsample(t.xsize, t.bits), subsample(ysize, t.bits),
                      false, nullptr);
    } else if (type == 3) {  // colour indexing
      int ncolors = br.read(8) + 1;
      t.bits = ncolors > 16 ? 0 : ncolors > 4 ? 1 : ncolors > 2 ? 2 : 3;
      *xsize = subsample(t.xsize, t.bits);
      std::vector<uint32_t> pal = stream(ncolors, 1, false, nullptr);
      t.data.assign(1 << (8 >> t.bits), 0);  // past the palette: 0
      const uint8_t* src = (const uint8_t*)pal.data();
      uint8_t* dst = (uint8_t*)t.data.data();
      for (int i = 0; i < 4; ++i) dst[i] = src[i];
      for (int i = 4; i < 4 * ncolors; ++i)
        dst[i] = (uint8_t)(src[i] + dst[i - 4]);
    }
  }

  // One entropy-coded image: transforms (level 0 only), colour cache,
  // prefix codes (meta codes at level 0 only), then the pixels.
  std::vector<uint32_t> stream(int xsize, int ysize, bool level0,
                               int* coded_xsize) {
    int txs = xsize;
    if (level0)
      while (br.read(1)) read_transform(&txs, ysize);
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = br.read(4);
      if (cache_bits < 1 || cache_bits > 11)
        fail("VP8L: colour cache of %d bits", cache_bits);
    }
    Codes c;
    read_codes(c, txs, ysize, cache_bits, level0);
    std::vector<uint32_t> px((size_t)txs * ysize);
    pixels(px.data(), txs, ysize, c, cache_bits);
    check();
    if (coded_xsize) *coded_xsize = txs;
    return px;
  }

  void pixels(uint32_t* data, int w, int h, const Codes& c, int cache_bits) {
    const size_t total = (size_t)w * h;
    const int len_limit = 256 + 24;
    const int cache_limit = len_limit + (cache_bits ? 1 << cache_bits : 0);
    const uint32_t mask = c.bits ? (1u << c.bits) - 1 : ~0u;
    std::vector<uint32_t> cache(cache_bits ? 1u << cache_bits : 0);
    const int shift = 32 - cache_bits;
    size_t i = 0, cached = 0;
    int col = 0, row = 0;
    auto group = [&](int x, int y) -> const Group& {
      if (!c.bits) return c.groups[0];
      return c.groups[c.image[(size_t)c.xsize * (y >> c.bits) +
                              (x >> c.bits)]];
    };
    auto insert = [&]() {
      if (cache_bits)
        for (; cached < i; ++cached)
          cache[(0x1e35a7bdu * data[cached]) >> shift] = data[cached];
    };
    const Group* g = &group(0, 0);
    while (i < total) {
      if ((col & mask) == 0) g = &group(col, row);
      int code = symbol(c.tables, g->code[GREEN]);
      if (code < 256 || code >= len_limit) {
        if (code < 256) {
          int red = symbol(c.tables, g->code[RED]);
          int blue = symbol(c.tables, g->code[BLUE]);
          int alpha = symbol(c.tables, g->code[ALPHA]);
          data[i] = ((uint32_t)alpha << 24) | (red << 16) | (code << 8) | blue;
        } else {
          if (code >= cache_limit) fail("VP8L: symbol %d out of range", code);
          insert();
          data[i] = cache[code - len_limit];
        }
        ++i;
        if (++col >= w) {
          col = 0;
          ++row;
        }
        continue;
      }
      int length = copy_value(code - 256);
      int dsym = symbol(c.tables, g->code[DIST]);
      int dcode = copy_value(dsym);
      size_t dist;
      if (dcode > 120) {
        dist = dcode - 120;
      } else {
        int v = kCodeToPlane[dcode - 1];
        long d = (long)(v >> 4) * w + (8 - (v & 0xf));
        dist = d >= 1 ? d : 1;
      }
      if (br.over()) break;
      if (i < dist || total - i < (size_t)length)
        fail("VP8L: a copy outside the image");
      for (int k = 0; k < length; ++k) data[i + k] = data[i + k - dist];
      i += length;
      col += length;
      while (col >= w) {
        col -= w;
        ++row;
      }
      if (col & mask) g = &group(col, row);
    }
    insert();
    check();
  }

  int copy_value(int sym) {
    if (sym < 4) return sym + 1;
    int extra = (sym - 2) >> 1;
    int offset = (2 + (sym & 1)) << extra;
    return offset + br.read(extra) + 1;
  }

  // The inverse transforms, last read first, on the decoded image of
  // width `w`; returns the image at the full width.
  std::vector<uint32_t> untransform(std::vector<uint32_t> px, int w, int h) {
    for (int k = ntr - 1; k >= 0; --k) {
      Transform& t = tr[k];
      if (t.type == 0) {
        predictor(px.data(), t, h);
      } else if (t.type == 1) {
        cross_colour(px.data(), t, h);
      } else if (t.type == 2) {
        for (uint32_t& p : px) {
          uint32_t green = (p >> 8) & 0xff;
          uint32_t rb = (p & 0x00ff00ff) + ((green << 16) | green);
          p = (p & 0xff00ff00) | (rb & 0x00ff00ff);
        }
      } else {
        std::vector<uint32_t> out((size_t)t.xsize * h);
        int bpp = 8 >> t.bits;
        int per = 1 << t.bits;
        uint32_t bmask = (1u << bpp) - 1;
        for (int y = 0; y < h; ++y) {
          const uint32_t* src = px.data() + (size_t)y * w;
          uint32_t* dst = out.data() + (size_t)y * t.xsize;
          uint32_t packed = 0;
          for (int x = 0; x < t.xsize; ++x) {
            if ((x & (per - 1)) == 0) packed = (*src++ >> 8) & 0xff;
            dst[x] = t.data[packed & bmask];
            packed >>= bpp;
          }
        }
        px.swap(out);
      }
      w = t.xsize;
    }
    return px;
  }

  static uint32_t add(uint32_t a, uint32_t b) {
    uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
    uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
    return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
  }
  static uint32_t avg2(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
  }
  static int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
  static uint32_t select(uint32_t a, uint32_t b, uint32_t c) {
    int s = 0;
    for (int sh = 0; sh < 32; sh += 8) {
      int x = (a >> sh) & 0xff, y = (b >> sh) & 0xff, z = (c >> sh) & 0xff;
      s += abs(y - z) - abs(x - z);
    }
    return s <= 0 ? a : b;
  }
  static uint32_t add_sub_full(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t r = 0;
    for (int sh = 0; sh < 32; sh += 8)
      r |= (uint32_t)clip255((int)((a >> sh) & 0xff) + (int)((b >> sh) & 0xff)
                             - (int)((c >> sh) & 0xff)) << sh;
    return r;
  }
  static uint32_t add_sub_half(uint32_t a, uint32_t b) {
    uint32_t r = 0;
    for (int sh = 0; sh < 32; sh += 8) {
      int x = (a >> sh) & 0xff, y = (b >> sh) & 0xff;
      r |= (uint32_t)clip255(x + (x - y) / 2) << sh;
    }
    return r;
  }
  static uint32_t predict(int mode, const uint32_t* cur, const uint32_t* up) {
    const uint32_t L = cur[-1], T = up[0], TR = up[1], TL = up[-1];
    switch (mode) {
      case 1: return L;
      case 2: return T;
      case 3: return TR;
      case 4: return TL;
      case 5: return avg2(avg2(L, TR), T);
      case 6: return avg2(L, TL);
      case 7: return avg2(L, T);
      case 8: return avg2(TL, T);
      case 9: return avg2(T, TR);
      case 10: return avg2(avg2(L, TL), avg2(T, TR));
      case 11: return select(T, L, TL);
      case 12: return add_sub_full(L, T, TL);
      case 13: return add_sub_half(avg2(L, T), TL);
      default: return 0xff000000u;  // 0, and 14, 15 as libwebp has them
    }
  }

  void predictor(uint32_t* px, const Transform& t, int h) {
    const int w = t.xsize;
    const int tiles = subsample(w, t.bits);
    px[0] = add(px[0], 0xff000000u);
    for (int x = 1; x < w; ++x) px[x] = add(px[x], px[x - 1]);
    for (int y = 1; y < h; ++y) {
      uint32_t* cur = px + (size_t)y * w;
      const uint32_t* up = cur - w;
      const uint32_t* modes = t.data.data() + (size_t)(y >> t.bits) * tiles;
      cur[0] = add(cur[0], up[0]);
      for (int x = 1; x < w; ++x) {
        int mode = (modes[x >> t.bits] >> 8) & 0xf;
        cur[x] = add(cur[x], predict(mode, cur + x, up + x));
      }
    }
  }

  void cross_colour(uint32_t* px, const Transform& t, int h) {
    const int w = t.xsize;
    const int tiles = subsample(w, t.bits);
    for (int y = 0; y < h; ++y) {
      uint32_t* cur = px + (size_t)y * w;
      const uint32_t* codes = t.data.data() + (size_t)(y >> t.bits) * tiles;
      for (int x = 0; x < w; ++x) {
        uint32_t m = codes[x >> t.bits];
        int8_t g2r = (int8_t)(m & 0xff), g2b = (int8_t)((m >> 8) & 0xff),
               r2b = (int8_t)((m >> 16) & 0xff);
        uint32_t argb = cur[x];
        int8_t green = (int8_t)(argb >> 8);
        int red = (argb >> 16) & 0xff, blue = argb & 0xff;
        red = (red + ((g2r * green) >> 5)) & 0xff;
        blue += (g2b * green) >> 5;
        blue += (r2b * (int8_t)red) >> 5;
        blue &= 0xff;
        cur[x] = (argb & 0xff00ff00u) | ((uint32_t)red << 16) | blue;
      }
    }
  }
};

// The ARGB pixels of a VP8L bitstream (the chunk's payload on): its
// 5-byte header, then the level-0 image.
std::vector<uint32_t> decode_vp8l(const uint8_t* d, size_t n, int* w,
                                  int* h) {
  VP8L dec(d, n);
  if (dec.br.read(8) != 0x2f) fail("VP8L: bad signature");
  *w = dec.br.read(14) + 1;
  *h = dec.br.read(14) + 1;
  dec.br.read(1);  // alpha used: cv2's RGB does not depend on it
  if (dec.br.read(3) != 0) fail("VP8L: unknown version");
  dec.check();
  int coded;
  std::vector<uint32_t> px = dec.stream(*w, *h, true, &coded);
  return dec.untransform(std::move(px), coded, *h);
}

// ------------------------------------------------------------------ VP8

// The boolean decoder as libwebp keeps it: range minus one, a value
// whose top bits sit at `bits`; a byte needed past the partition's end
// reads as zero once and sets eof, which fails the decode.
struct BoolDec {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  uint32_t range = 254;
  int bits = -8;
  int eof = 0;
  void init(const uint8_t* s, size_t n) {
    buf = s;
    end = s + n;
    value = 0;
    range = 254;
    bits = -8;
    eof = 0;
    load();
  }
  void load() {
    if (buf < end) {
      bits += 8;
      value = (value << 8) | *buf++;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = 1;
    } else {
      bits = 0;
    }
  }
  int get(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const uint32_t v = (uint32_t)(value >> pos);
    const int bit = v > split;
    if (bit) {
      r -= split;
      value -= (uint64_t)(split + 1) << pos;
    } else {
      r = split + 1;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  uint32_t value_bits(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= (uint32_t)get(0x80) << n;
    return v;
  }
  int signed_value(int n) {
    const int v = (int)value_bits(n);
    return value_bits(1) ? -v : v;
  }
  int get_signed(int v) {  // libwebp's VP8GetSigned
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = (uint32_t)(value >> pos);
    const int32_t mask = (int32_t)(split - val) >> 31;
    bits -= 1;
    range += (uint32_t)mask;
    range |= 1;
    value -= (uint64_t)((split + 1) & (uint32_t)mask) << pos;
    return (v ^ mask) - mask;
  }
};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// sub-block modes, in the order of kBModesProba
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
// 16x16 and chroma DC where neighbours are missing
enum { DC_NOTOP = 10, DC_NOLEFT, DC_NOTOPLEFT };

const int BPS = 32;
const int Y_OFF = BPS * 1 + 8;
const int U_OFF = Y_OFF + BPS * 16 + BPS;
const int V_OFF = U_OFF + 16;
const int kScan[16] = {0,           4,           8,           12,
                       0 + 4 * BPS, 4 + 4 * BPS, 8 + 4 * BPS, 12 + 4 * BPS,
                       0 + 8 * BPS, 4 + 8 * BPS, 8 + 8 * BPS, 12 + 8 * BPS,
                       0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS,
                       12 + 12 * BPS};

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void transform(const int16_t* in, uint8_t* dst) {
  int C[16], *tmp = C;
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += BPS;
  }
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

// ---- intra prediction (dst inside the BPS work buffer)

#define DST(x, y) dst[(x) + (y) * BPS]
inline uint8_t avg3(int a, int b, int c) { return (uint8_t)((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + l - tl);
    dst += BPS;
  }
}

void fill(uint8_t* dst, int v, int size) {
  for (int j = 0; j < size; ++j) memset(dst + j * BPS, v, size);
}

void pred_large(uint8_t* dst, int mode, int size) {  // 16x16 or chroma 8x8
  const int shift = size == 16 ? 5 : 4;
  int dc;
  switch (mode) {
    case B_TM: true_motion(dst, size); return;
    case B_VE:
      for (int j = 0; j < size; ++j) memcpy(dst + j * BPS, dst - BPS, size);
      return;
    case B_HE:
      for (int j = 0; j < size; ++j) memset(dst + j * BPS, dst[j * BPS - 1], size);
      return;
    case B_DC:
      dc = size;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, dc >> shift, size);
      return;
    case DC_NOTOP:
      dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      fill(dst, dc >> (shift - 1), size);
      return;
    case DC_NOLEFT:
      dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      fill(dst, dc >> (shift - 1), size);
      return;
    default:
      fill(dst, 0x80, size);
  }
}

void pred4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
            L = dst[-1 + 3 * BPS], X = top[-1];
  const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4],
            F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, dc >> 3, 4);
      break;
    }
    case B_TM: true_motion(dst, 4); break;
    case B_VE: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                            avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, v, 4);
      break;
    }
    case B_HE: {
      const int Ax = X;
      memset(dst, avg3(Ax, I, J), 4);
      memset(dst + BPS, avg3(I, J, K), 4);
      memset(dst + 2 * BPS, avg3(J, K, L), 4);
      memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    }
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HU:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
          DST(3, 3) = (uint8_t)L;
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
  }
}
#undef DST

// ---- loop filters (p: the first pixel past the edge)

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return abs(p1 - p0) > thresh || abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * abs(p0 - q0) + abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * abs(p0 - q0) + abs(p1 - q1) > t) return false;
  return abs(p3 - p2) <= it && abs(p2 - p1) <= it && abs(p1 - p0) <= it &&
         abs(q3 - q2) <= it && abs(q2 - q1) <= it && abs(q1 - q0) <= it;
}

// `hstride` crosses the edge, `vstride` runs along it
void simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) do_filter2(p, hstride);
}

void normal_edge(uint8_t* p, int hstride, int vstride, int size, int thresh,
                 int ithresh, int hev_t, bool mb_edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_t)) do_filter2(p, hstride);
    else if (mb_edge) do_filter6(p, hstride);
    else do_filter4(p, hstride);
  }
}

struct FInfo {
  int limit, ilevel, inner, hev_thresh;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4, uvmode, segment, skip;
  uint8_t imodes[16];
  uint32_t non_zero_y, non_zero_uv;
};

struct VP8 {
  int W, H, mb_w, mb_h;
  BoolDec br;
  BoolDec parts[8];
  int num_parts_minus_one = 0;
  // headers
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0}, filter_strength[4] = {0};
  uint8_t segment_probs[3] = {255, 255, 255};
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  int filter_type = 0;
  int y1_mat[4][2], y2_mat[4][2], uv_mat[4][2];
  uint8_t probas[4][8][3][11];
  int use_skip_proba = 0, skip_p = 0;
  FInfo fstrengths[4][2];
  // state
  std::vector<uint8_t> intra_t;
  uint8_t intra_l[4];
  std::vector<uint8_t> nz_top, nz_dc_top;
  uint8_t nz_left = 0, nz_dc_left = 0;
  std::vector<uint8_t> Y, U, V;  // macroblock-aligned planes
  std::vector<uint8_t> top_y, top_u, top_v;
  std::vector<FInfo> finfo;
  uint8_t yuv_b[BPS * 17 + BPS * 9];

  void parse_headers(const uint8_t* buf, size_t size) {
    if (size < 4) fail("VP8: truncated header");
    const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
    const int key_frame = !(bits & 1);
    const int profile = (bits >> 1) & 7;
    const int show = (bits >> 4) & 1;
    const uint32_t part_length = bits >> 5;
    if (profile > 3) fail("VP8: incorrect keyframe parameters");
    if (!show) fail("VP8: frame not displayable");
    if (!key_frame) fail("VP8: not a key frame");
    buf += 3;
    size -= 3;
    if (size < 7) fail("VP8: cannot parse picture header");
    if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a)
      fail("VP8: bad code word");
    W = ((buf[4] << 8) | buf[3]) & 0x3fff;
    H = ((buf[6] << 8) | buf[5]) & 0x3fff;
    buf += 7;
    size -= 7;
    mb_w = (W + 15) >> 4;
    mb_h = (H + 15) >> 4;
    if (part_length > size) fail("VP8: bad partition length");
    br.init(buf, part_length);
    buf += part_length;
    size -= part_length;
    br.value_bits(1);  // colour space
    br.value_bits(1);  // clamping type: the pixels are always clamped
    // segment header
    use_segment = br.value_bits(1);
    if (use_segment) {
      update_map = br.value_bits(1);
      if (br.value_bits(1)) {
        absolute_delta = br.value_bits(1);
        for (int s = 0; s < 4; ++s)
          quantizer[s] = br.value_bits(1) ? br.signed_value(7) : 0;
        for (int s = 0; s < 4; ++s)
          filter_strength[s] = br.value_bits(1) ? br.signed_value(6) : 0;
      }
      if (update_map)
        for (int s = 0; s < 3; ++s)
          segment_probs[s] = br.value_bits(1) ? br.value_bits(8) : 255;
    }
    if (br.eof) fail("VP8: cannot parse segment header");
    // filter header
    simple = br.value_bits(1);
    level = br.value_bits(6);
    sharpness = br.value_bits(3);
    use_lf_delta = br.value_bits(1);
    if (use_lf_delta && br.value_bits(1)) {
      for (int i = 0; i < 4; ++i)
        if (br.value_bits(1)) ref_lf_delta[i] = br.signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br.value_bits(1)) mode_lf_delta[i] = br.signed_value(6);
    }
    filter_type = level == 0 ? 0 : simple ? 1 : 2;
    if (br.eof) fail("VP8: cannot parse filter header");
    // token partitions
    num_parts_minus_one = (1 << br.value_bits(2)) - 1;
    const size_t last = num_parts_minus_one;
    if (size < 3 * last) fail("VP8: cannot parse partitions");
    const uint8_t* sz = buf;
    const uint8_t* part = buf + 3 * last;
    size_t left = size - 3 * last;
    for (size_t p = 0; p < last; ++p) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > left) psize = left;
      parts[p].init(part, psize);
      part += psize;
      left -= psize;
      sz += 3;
    }
    parts[last].init(part, left);
    if (left == 0) fail("VP8: cannot parse partitions (no data)");
    parse_quant();
    br.value_bits(1);  // update_proba: ignored
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            probas[t][b][c][p] = br.get(kCoeffsUpdateProba[t][b][c][p])
                                     ? br.value_bits(8)
                                     : kCoeffsProba0[t][b][c][p];
    use_skip_proba = br.value_bits(1);
    if (use_skip_proba) skip_p = br.value_bits(8);
  }

  static int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

  void parse_quant() {
    const int base_q0 = br.value_bits(7);
    const int dqy1_dc = br.value_bits(1) ? br.signed_value(4) : 0;
    const int dqy2_dc = br.value_bits(1) ? br.signed_value(4) : 0;
    const int dqy2_ac = br.value_bits(1) ? br.signed_value(4) : 0;
    const int dquv_dc = br.value_bits(1) ? br.signed_value(4) : 0;
    const int dquv_ac = br.value_bits(1) ? br.signed_value(4) : 0;
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment) {
        q = quantizer[i];
        if (!absolute_delta) q += base_q0;
      } else if (i > 0) {
        memcpy(y1_mat[i], y1_mat[0], sizeof(y1_mat[0]));
        memcpy(y2_mat[i], y2_mat[0], sizeof(y2_mat[0]));
        memcpy(uv_mat[i], uv_mat[0], sizeof(uv_mat[0]));
        continue;
      } else {
        q = base_q0;
      }
      y1_mat[i][0] = kDcTable[clip(q + dqy1_dc, 127)];
      y1_mat[i][1] = kAcTable[clip(q + 0, 127)];
      y2_mat[i][0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      y2_mat[i][1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (y2_mat[i][1] < 8) y2_mat[i][1] = 8;
      uv_mat[i][0] = kDcTable[clip(q + dquv_dc, 117)];
      uv_mat[i][1] = kAcTable[clip(q + dquv_ac, 127)];
    }
  }

  void precompute_filter_strengths() {
    if (filter_type == 0) return;
    for (int s = 0; s < 4; ++s) {
      int base_level;
      if (use_segment) {
        base_level = filter_strength[s];
        if (!absolute_delta) base_level += level;
      } else {
        base_level = level;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FInfo& info = fstrengths[s][i4x4];
        int lvl = base_level;
        if (use_lf_delta) {
          lvl += ref_lf_delta[0];
          if (i4x4) lvl += mode_lf_delta[0];
        }
        lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
        if (lvl > 0) {
          int ilevel = lvl;
          if (sharpness > 0) {
            ilevel >>= sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * lvl + ilevel;
          info.hev_thresh = lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
          info.ilevel = 0;
          info.hev_thresh = 0;
        }
        info.inner = i4x4;
      }
    }
  }

  void parse_intra_mode(MBData& b, int mb_x) {
    uint8_t* top = &intra_t[4 * mb_x];
    uint8_t* left = intra_l;
    if (update_map) {
      b.segment = !br.get(segment_probs[0]) ? br.get(segment_probs[1])
                                            : br.get(segment_probs[2]) + 2;
    } else {
      b.segment = 0;
    }
    b.skip = use_skip_proba ? br.get(skip_p) : 0;
    b.is_i4x4 = !br.get(145);
    if (!b.is_i4x4) {
      const int ymode = br.get(156) ? (br.get(128) ? B_TM : B_HE)
                                    : (br.get(163) ? B_VE : B_DC);
      b.imodes[0] = ymode;
      memset(top, ymode, 4);
      memset(left, ymode, 4);
    } else {
      uint8_t* modes = b.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba[top[x]][ymode];
          ymode = !br.get(prob[0]) ? B_DC
                : !br.get(prob[1]) ? B_TM
                : !br.get(prob[2]) ? B_VE
                : !br.get(prob[3])
                    ? (!br.get(prob[4]) ? B_HE
                       : !br.get(prob[5]) ? B_RD : B_VR)
                    : (!br.get(prob[6]) ? B_LD
                       : !br.get(prob[7]) ? B_VL
                       : !br.get(prob[8]) ? B_HD : B_HU);
          top[x] = ymode;
        }
        memcpy(modes, top, 4);
        modes += 4;
        left[y] = ymode;
      }
    }
    b.uvmode = !br.get(142) ? B_DC
             : !br.get(114) ? B_VE
             : br.get(183) ? B_TM : B_HE;
  }

  int large_value(BoolDec& t, const uint8_t* p) {
    int v;
    if (!t.get(p[3])) {
      v = !t.get(p[4]) ? 2 : 3 + t.get(p[5]);
    } else if (!t.get(p[6])) {
      if (!t.get(p[7])) {
        v = 5 + t.get(159);
      } else {
        v = 7 + 2 * t.get(165);
        v += t.get(145);
      }
    } else {
      const int bit1 = t.get(p[8]);
      const int bit0 = t.get(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + t.get(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  // Tokens of one 4x4 block from position n; returns the position after
  // the last non-zero coefficient (16 when the block runs to its end).
  int coeffs(BoolDec& t, int type, int ctx, const int* dq, int n,
             int16_t* out) {
    const uint8_t* p = probas[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!t.get(p[0])) return n;
      while (!t.get(p[1])) {
        p = probas[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      const int band = kBands[n + 1];
      if (!t.get(p[2])) {
        v = 1;
        p = probas[type][band][1];
      } else {
        v = large_value(t, p);
        p = probas[type][band][2];
      }
      out[kZigzag[n]] = (int16_t)(t.get_signed(v) * dq[n > 0]);
    }
    return 16;
  }

  static uint32_t nz_code(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
    return nz_coeffs;
  }

  // libwebp's ParseResiduals; returns whether every coefficient is zero
  int residuals(MBData& b, int mb_x, BoolDec& t) {
    const int seg = b.segment;
    int16_t* dst = b.coeffs;
    uint8_t& mb_nz = nz_top[mb_x];
    uint8_t& mb_nz_dc = nz_dc_top[mb_x];
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    int first, ac_type;
    memset(dst, 0, sizeof(b.coeffs));
    if (!b.is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = mb_nz_dc + nz_dc_left;
      const int nz = coeffs(t, 1, ctx, y2_mat[seg], 0, dc);
      mb_nz_dc = nz_dc_left = (nz > 0);
      if (nz > 1) {
        transform_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 16 * 16; i += 16) dst[i] = (int16_t)dc0;
      }
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    uint8_t tnz = mb_nz & 0x0f;
    uint8_t lnz = nz_left & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nzc = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = coeffs(t, ac_type, ctx, y1_mat[seg], first, dst);
        l = (nz > first);
        tnz = (tnz >> 1) | (l << 7);
        nzc = nz_code(nzc, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = (lnz >> 1) | (l << 7);
      non_zero_y = (non_zero_y << 8) | nzc;
    }
    uint32_t out_t_nz = tnz;
    uint32_t out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nzc = 0;
      tnz = mb_nz >> (4 + ch);
      lnz = nz_left >> (4 + ch);
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = coeffs(t, 2, ctx, uv_mat[seg], 0, dst);
          l = (nz > 0);
          tnz = (tnz >> 1) | (l << 3);
          nzc = nz_code(nzc, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = (lnz >> 1) | (l << 5);
      }
      non_zero_uv |= nzc << (4 * ch);
      out_t_nz |= (tnz << 4) << ch;
      out_l_nz |= (lnz & 0xf0) << ch;
    }
    mb_nz = (uint8_t)out_t_nz;
    nz_left = (uint8_t)out_l_nz;
    b.non_zero_y = non_zero_y;
    b.non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
  }

  static int check_mode(int mb_x, int mb_y, int mode) {
    if (mode == B_DC) {
      if (mb_x == 0) return mb_y == 0 ? (int)DC_NOTOPLEFT : (int)DC_NOLEFT;
      return mb_y == 0 ? (int)DC_NOTOP : (int)B_DC;
    }
    return mode;
  }

  static bool any(const int16_t* c) {
    for (int i = 0; i < 16; ++i)
      if (c[i]) return true;
    return false;
  }

  // libwebp's ReconstructRow for one macroblock, then the copy into the
  // planes
  void reconstruct(const MBData& b, int mb_x, int mb_y) {
    uint8_t* const y_dst = yuv_b + Y_OFF;
    uint8_t* const u_dst = yuv_b + U_OFF;
    uint8_t* const v_dst = yuv_b + V_OFF;
    if (mb_x == 0) {
      for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
      for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
      if (mb_y > 0) {
        y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
      } else {
        memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
        memset(u_dst - BPS - 1, 127, 8 + 1);
        memset(v_dst - BPS - 1, 127, 8 + 1);
      }
    } else {
      for (int j = -1; j < 16; ++j) memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
      for (int j = -1; j < 8; ++j) {
        memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
        memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
      }
    }
    uint8_t* ty = &top_y[16 * mb_x];
    uint8_t* tu = &top_u[8 * mb_x];
    uint8_t* tv = &top_v[8 * mb_x];
    if (mb_y > 0) {
      memcpy(y_dst - BPS, ty, 16);
      memcpy(u_dst - BPS, tu, 8);
      memcpy(v_dst - BPS, tv, 8);
    }
    const int16_t* coeffs_ = b.coeffs;
    if (b.is_i4x4) {
      uint8_t* top_right = y_dst - BPS + 16;
      if (mb_y > 0) {
        if (mb_x >= mb_w - 1) memset(top_right, ty[15], 4);
        else memcpy(top_right, ty + 16, 4);
      }
      for (int k = 1; k <= 3; ++k) memcpy(top_right + k * 4 * BPS, top_right, 4);
      for (int n = 0; n < 16; ++n) {
        uint8_t* dst = y_dst + kScan[n];
        pred4(dst, b.imodes[n]);
        if (any(coeffs_ + n * 16)) transform(coeffs_ + n * 16, dst);
      }
    } else {
      pred_large(y_dst, check_mode(mb_x, mb_y, b.imodes[0]), 16);
      for (int n = 0; n < 16; ++n)
        if (any(coeffs_ + n * 16)) transform(coeffs_ + n * 16, y_dst + kScan[n]);
    }
    const int uvmode = check_mode(mb_x, mb_y, b.uvmode);
    pred_large(u_dst, uvmode, 8);
    pred_large(v_dst, uvmode, 8);
    for (int n = 0; n < 4; ++n) {
      const int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
      if (any(coeffs_ + 256 + n * 16)) transform(coeffs_ + 256 + n * 16, u_dst + off);
      if (any(coeffs_ + 320 + n * 16)) transform(coeffs_ + 320 + n * 16, v_dst + off);
    }
    if (mb_y < mb_h - 1) {
      memcpy(ty, y_dst + 15 * BPS, 16);
      memcpy(tu, u_dst + 7 * BPS, 8);
      memcpy(tv, v_dst + 7 * BPS, 8);
    }
    const size_t ys = (size_t)mb_w * 16, uvs = (size_t)mb_w * 8;
    for (int j = 0; j < 16; ++j)
      memcpy(&Y[(mb_y * 16 + j) * ys + mb_x * 16], y_dst + j * BPS, 16);
    for (int j = 0; j < 8; ++j) {
      memcpy(&U[(mb_y * 8 + j) * uvs + mb_x * 8], u_dst + j * BPS, 8);
      memcpy(&V[(mb_y * 8 + j) * uvs + mb_x * 8], v_dst + j * BPS, 8);
    }
  }

  void filter_mb(int mb_x, int mb_y) {
    const FInfo& f = finfo[(size_t)mb_y * mb_w + mb_x];
    const int limit = f.limit;
    if (limit == 0) return;
    const int ys = mb_w * 16, uvs = mb_w * 8;
    uint8_t* y = &Y[(size_t)mb_y * 16 * ys + mb_x * 16];
    if (filter_type == 1) {
      if (mb_x > 0) simple_edge(y, 1, ys, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_edge(y + 4 * k, 1, ys, limit);
      if (mb_y > 0) simple_edge(y, ys, 1, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_edge(y + 4 * k * ys, ys, 1, limit);
      return;
    }
    uint8_t* u = &U[(size_t)mb_y * 8 * uvs + mb_x * 8];
    uint8_t* v = &V[(size_t)mb_y * 8 * uvs + mb_x * 8];
    const int il = f.ilevel, hv = f.hev_thresh;
    if (mb_x > 0) {
      normal_edge(y, 1, ys, 16, limit + 4, il, hv, true);
      normal_edge(u, 1, uvs, 8, limit + 4, il, hv, true);
      normal_edge(v, 1, uvs, 8, limit + 4, il, hv, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) normal_edge(y + 4 * k, 1, ys, 16, limit, il, hv, false);
      normal_edge(u + 4, 1, uvs, 8, limit, il, hv, false);
      normal_edge(v + 4, 1, uvs, 8, limit, il, hv, false);
    }
    if (mb_y > 0) {
      normal_edge(y, ys, 1, 16, limit + 4, il, hv, true);
      normal_edge(u, uvs, 1, 8, limit + 4, il, hv, true);
      normal_edge(v, uvs, 1, 8, limit + 4, il, hv, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) normal_edge(y + 4 * k * ys, ys, 1, 16, limit, il, hv, false);
      normal_edge(u + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
      normal_edge(v + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
    }
  }

  void decode(const uint8_t* data, size_t size) {
    parse_headers(data, size);
    precompute_filter_strengths();
    intra_t.assign(4 * mb_w, B_DC);
    nz_top.assign(mb_w, 0);
    nz_dc_top.assign(mb_w, 0);
    Y.assign((size_t)mb_w * 16 * mb_h * 16, 0);
    U.assign((size_t)mb_w * 8 * mb_h * 8, 0);
    V.assign(U.size(), 0);
    top_y.assign(16 * mb_w, 0);
    top_u.assign(8 * mb_w, 0);
    top_v.assign(8 * mb_w, 0);
    finfo.assign((size_t)mb_w * mb_h, FInfo{0, 0, 0, 0});
    memset(yuv_b, 0, sizeof(yuv_b));
    std::vector<MBData> row(mb_w);
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      BoolDec& tokens = parts[mb_y & num_parts_minus_one];
      memset(intra_l, B_DC, sizeof(intra_l));
      nz_left = nz_dc_left = 0;
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) parse_intra_mode(row[mb_x], mb_x);
      if (br.eof) fail("VP8: premature end of partition 0");
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        MBData& b = row[mb_x];
        int skip = use_skip_proba ? b.skip : 0;
        if (!skip) {
          skip = residuals(b, mb_x, tokens);
        } else {
          nz_left = nz_top[mb_x] = 0;
          if (!b.is_i4x4) nz_dc_left = nz_dc_top[mb_x] = 0;
          b.non_zero_y = b.non_zero_uv = 0;
          memset(b.coeffs, 0, sizeof(b.coeffs));
        }
        if (filter_type > 0) {
          FInfo f = fstrengths[b.segment][b.is_i4x4];
          f.inner |= !skip;
          finfo[(size_t)mb_y * mb_w + mb_x] = f;
        }
        if (tokens.eof) fail("VP8: premature end of file");
        reconstruct(b, mb_x, mb_y);
      }
    }
    if (filter_type > 0)
      for (int mb_y = 0; mb_y < mb_h; ++mb_y)
        for (int mb_x = 0; mb_x < mb_w; ++mb_x) filter_mb(mb_x, mb_y);
  }
};

// ---- output: libwebp's fancy upsampler and YUV -> RGB (src/dsp/yuv.h)

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) {
  return ((v & ~16383) == 0) ? (uint8_t)(v >> 6) : (v < 0) ? 0 : 255;
}
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) -
                     mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// One pair of output rows (bottom_y may be null) from the chroma rows
// above (top_u/v) and below (cur_u/v) them: libwebp's UpsampleRgbLinePair.
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y,
                   const uint8_t* top_u, const uint8_t* top_v,
                   const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
#define LOAD_UV(u, v) ((u) | ((v) << 16))
  const int last_pixel_pair = (len - 1) >> 1;
  uint32_t tl_uv = LOAD_UV(top_u[0], top_v[0]);
  uint32_t l_uv = LOAD_UV(cur_u[0], cur_v[0]);
  {
    const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    yuv_to_rgb(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
  }
  if (bottom_y) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    yuv_to_rgb(bottom_y[0], uv0 & 0xff, uv0 >> 16, bottom_dst);
  }
  for (int x = 1; x <= last_pixel_pair; ++x) {
    const uint32_t t_uv = LOAD_UV(top_u[x], top_v[x]);
    const uint32_t uv = LOAD_UV(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
      const uint32_t uv1 = (diag_03 + t_uv) >> 1;
      yuv_to_rgb(top_y[2 * x - 1], uv0 & 0xff, uv0 >> 16,
                 top_dst + (2 * x - 1) * 3);
      yuv_to_rgb(top_y[2 * x], uv1 & 0xff, uv1 >> 16, top_dst + 2 * x * 3);
    }
    if (bottom_y) {
      const uint32_t uv0 = (diag_03 + l_uv) >> 1;
      const uint32_t uv1 = (diag_12 + uv) >> 1;
      yuv_to_rgb(bottom_y[2 * x - 1], uv0 & 0xff, uv0 >> 16,
                 bottom_dst + (2 * x - 1) * 3);
      yuv_to_rgb(bottom_y[2 * x], uv1 & 0xff, uv1 >> 16,
                 bottom_dst + 2 * x * 3);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      yuv_to_rgb(top_y[len - 1], uv0 & 0xff, uv0 >> 16,
                 top_dst + (len - 1) * 3);
    }
    if (bottom_y) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      yuv_to_rgb(bottom_y[len - 1], uv0 & 0xff, uv0 >> 16,
                 bottom_dst + (len - 1) * 3);
    }
  }
#undef LOAD_UV
}

// The whole frame as libwebp's EmitFancyRGB emits it: row 0 from chroma
// row 0 alone, rows 2k-1 and 2k from chroma rows k-1 and k, and the
// last row of an even height from the last chroma row alone.
void emit_rgb(const VP8& d, uint8_t* rgb) {
  const int W = d.W, H = d.H;
  const size_t ys = (size_t)d.mb_w * 16, uvs = (size_t)d.mb_w * 8;
  const uint8_t* Y = d.Y.data();
  const uint8_t* U = d.U.data();
  const uint8_t* V = d.V.data();
  const size_t stride = (size_t)W * 3;
  upsample_pair(Y, nullptr, U, V, U, V, rgb, nullptr, W);
  int y = 0;
  for (; y + 2 < H; y += 2) {
    const size_t k = y / 2;
    upsample_pair(Y + (y + 1) * ys, Y + (y + 2) * ys, U + k * uvs,
                  V + k * uvs, U + (k + 1) * uvs, V + (k + 1) * uvs,
                  rgb + (y + 1) * stride, rgb + (y + 2) * stride, W);
  }
  if (!(H & 1)) {
    const size_t k = (H - 1) / 2;
    upsample_pair(Y + (H - 1) * ys, nullptr, U + k * uvs, V + k * uvs,
                  U + k * uvs, V + k * uvs, rgb + (H - 1) * stride, nullptr,
                  W);
  }
}

// ------------------------------------------------------------------ ALPH

std::vector<uint8_t> decode_alpha(const uint8_t* d, size_t n, int w, int h) {
  if (n <= 1) fail("ALPH: no data");
  const int method = d[0] & 3, filter = (d[0] >> 2) & 3,
            pre = (d[0] >> 4) & 3, rsrv = (d[0] >> 6) & 3;
  if (method > 1 || pre > 1 || rsrv != 0) fail("ALPH: bad header 0x%02x", d[0]);
  const size_t total = (size_t)w * h;
  std::vector<uint8_t> delta(total);
  if (method == 0) {
    if (n - 1 < total) fail("ALPH: %zu bytes for %zu pixels", n - 1, total);
    memcpy(delta.data(), d + 1, total);
  } else {
    VP8L dec(d + 1, n - 1);
    int coded;
    std::vector<uint32_t> px = dec.stream(w, h, true, &coded);
    px = dec.untransform(std::move(px), coded, h);
    for (size_t i = 0; i < total; ++i) delta[i] = (px[i] >> 8) & 0xff;
  }
  std::vector<uint8_t> out(total);
  for (int y = 0; y < h; ++y) {
    const uint8_t* in = &delta[(size_t)y * w];
    uint8_t* o = &out[(size_t)y * w];
    const uint8_t* prev = y ? o - w : nullptr;
    if (filter == 0) {
      memcpy(o, in, w);
    } else if (filter == 1 || !prev) {
      uint8_t pred = prev ? prev[0] : 0;
      for (int i = 0; i < w; ++i) pred = o[i] = (uint8_t)(pred + in[i]);
    } else if (filter == 2) {
      for (int i = 0; i < w; ++i) o[i] = (uint8_t)(prev[i] + in[i]);
    } else {
      uint8_t top = prev[0], top_left = top, left = top;
      for (int i = 0; i < w; ++i) {
        top = prev[i];
        const int g = left + top - top_left;
        left = (uint8_t)(in[i] + (((g & ~0xff) == 0) ? g : g < 0 ? 0 : 255));
        top_left = top;
        o[i] = left;
      }
    }
  }
  return out;
}

}  // namespace

extern "C" {

static int report(const char* msg, char* err, int errlen) {
  snprintf(err, errlen, "%s", msg);
  return 1;
}

// VP8 key frame (`data`: the VP8 payload to the end of the buffer, as
// libwebp reads it) into rgb (width * height * 3, the frame's size);
// 0, or 1 with the cause in err.
int mn_webp_vp8(const uint8_t* data, size_t n, int width, int height,
                uint8_t* rgb, char* err, int errlen) {
  try {
    VP8 dec;
    dec.decode(data, n);
    if (dec.W != width || dec.H != height) fail("VP8: frame size changed");
    emit_rgb(dec, rgb);
    return 0;
  } catch (const WebpError& e) {
    return report(e.msg.c_str(), err, errlen);
  } catch (const std::exception& e) {
    return report(e.what(), err, errlen);
  }
}

// VP8L bitstream (its 5-byte header on) into rgb (width * height * 3).
int mn_webp_vp8l(const uint8_t* data, size_t n, int width, int height,
                 uint8_t* rgb, char* err, int errlen) {
  try {
    int w, h;
    std::vector<uint32_t> px = decode_vp8l(data, n, &w, &h);
    if (w != width || h != height) fail("VP8L: image size changed");
    for (size_t i = 0; i < px.size(); ++i) {
      rgb[3 * i] = (px[i] >> 16) & 0xff;
      rgb[3 * i + 1] = (px[i] >> 8) & 0xff;
      rgb[3 * i + 2] = px[i] & 0xff;
    }
    return 0;
  } catch (const WebpError& e) {
    return report(e.msg.c_str(), err, errlen);
  } catch (const std::exception& e) {
    return report(e.what(), err, errlen);
  }
}

// ALPH chunk payload of a width x height frame into alpha (width *
// height).
int mn_webp_alpha(const uint8_t* data, size_t n, int width, int height,
                  uint8_t* alpha, char* err, int errlen) {
  try {
    std::vector<uint8_t> a = decode_alpha(data, n, width, height);
    memcpy(alpha, a.data(), a.size());
    return 0;
  } catch (const WebpError& e) {
    return report(e.msg.c_str(), err, errlen);
  } catch (const std::exception& e) {
    return report(e.what(), err, errlen);
  }
}

}  // extern "C"

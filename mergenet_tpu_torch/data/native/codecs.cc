// The byte-level decompressors of the port's raster readers
// (`data/codecs.py`; the containers are parsed in Python): each reads a
// compressed buffer into a caller-sized output and checks every bound,
// returning an error, never reading or writing past a buffer.
//
// - TIFF LZW (compression 5) as libtiff's tif_lzw.c decodes it: MSB-first
//   codes with the early width change (9 bits, then 10 from free code
//   511, 11 from 1023, 12 from 2047), clear 256, end 257; data whose
//   first two bytes are 0x00 and an odd byte is old-style (TIFF 5.0)
//   LZW: LSB-first codes, the width changing one code later.
// - GIF LZW: LSB-first codes from min_bits + 1 to 12 bits, clear
//   2^min_bits, end clear + 1, the width growing when the next free
//   code reaches 2^width; a full table stops growing until a clear.
// - PackBits (TIFF 32773): n < 128 copies n + 1 bytes, n > 128 repeats the
//   next byte 257 - n times, 128 is a no-op.
// - TIFF's horizontal predictor (2) undone on 8- and 16-bit samples.
// - CCITT (TIFF 2, 3, 4, 32771) as libtiff's tif_fax3.c reads it:
//   T.4's Modified Huffman and 2-D mode codes, read through libtiff's
//   own bit accumulator (so that 32771's rows are found where libtiff
//   finds them), each T.4 row after its EOL, fill bits skipped.
// - ThunderScan (TIFF 32809) as tif_thunder.c decodes it.
// - SGILog and SGILog24 (TIFF 34676, 34677) in libtiff's 8-bit output
//   (tif_luv.c).
// - BMP RLE8 and RLE4 as OpenCV's grfmt_bmp.cpp decodes them into rows
//   of palette indices (row 0 is the first decoded row: the bottom one
//   of a bottom-up file): runs and absolute runs must end within their
//   row (else the file is refused); RLE8 runs that end a row move to the
//   next one, so an end-of-line right after is skipped; end-of-line,
//   delta (a linear skip of dx + dy * width pixels) and end-of-bitmap
//   fill the pixels they pass with index 0.  In RLE4 (as OpenCV 5.0 has
//   it) end-of-bitmap only ends its row, as end-of-line does, and a
//   delta skips dx pixels: dy is read and ignored.
// - Radiance HDR scanlines as Greg Ward's RGBE_ReadPixels_RLE (the
//   rgbe.cpp OpenCV reads HDR with) reads them: widths below 8 or above
//   0x7fff are flat RGBE; a scanline that does not start 2 2 (width)
//   ends the run-length decoding, and the rest of the image, that
//   scanline's four bytes first, is flat RGBE; each of the four
//   components is runs (count > 128: count - 128 copies) and literals
//   (count bytes), neither of zero length or past the scanline.
//
// Plain C interface, loaded with ctypes; no library is linked.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <vector>

namespace {

struct Error {
  const char* msg;
};

void set_err(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) snprintf(err, errlen, "%s", msg);
}

// ------------------------------------------------------------------ LZW

// Decodes LZW: `msb` selects the bit order, `early` the width change
// one code earlier (TIFF new style).  A code's string is kept as where
// the decoder last wrote it in `out` and its length (a new entry is the
// previous string and the next byte, which follow each other there), so
// each code is one copy.  Stops at the end code or when the output is
// full (a string cut at the end, as libtiff fills a strip), and raises
// when the data runs short.
size_t lzw(const uint8_t* src, size_t n, int min_bits, bool msb, bool early,
           uint8_t* out, size_t cap) {
  size_t offset[4096], length[4096];
  const int clear = 1 << min_bits, eoi = clear + 1;
  int width = min_bits + 1, free_code = clear + 2, prev = -1;
  size_t pos = 0, prev_pos = 0, at = 0;
  uint32_t acc = 0;  // bits not yet taken: the low `have` of them
  int have = 0;
  while (pos < cap) {
    while (have < width) {
      if (at >= n) throw Error{"compressed data ends early"};
      acc = msb ? (acc << 8) | src[at++] : acc | (uint32_t)src[at++] << have;
      have += 8;
    }
    int code;
    if (msb) {
      code = (int)(acc >> (have - width)) & ((1 << width) - 1);
      have -= width;
      acc &= (1u << have) - 1;
    } else {
      code = (int)(acc & ((1u << width) - 1));
      acc >>= width;
      have -= width;
    }
    if (code == clear) {
      width = min_bits + 1;
      free_code = clear + 2;
      prev = -1;
      continue;
    }
    if (code == eoi) break;
    if (prev < 0 ? code >= clear : code > free_code ||
        (code == free_code && free_code >= 4096))
      throw Error{"corrupt LZW data (a code past the table)"};
    if (prev >= 0 && free_code < 4096) {
      offset[free_code] = prev_pos;
      length[free_code] = (prev < clear ? 1 : length[prev]) + 1;
      free_code++;
      if (free_code >= (1 << width) - (early ? 1 : 0) && width < 12) width++;
    }
    prev_pos = pos;
    if (code < clear) {
      out[pos++] = (uint8_t)code;
    } else {
      const size_t len = std::min(length[code], cap - pos);
      const uint8_t* from = out + offset[code];
      for (size_t k = 0; k < len; k++) out[pos + k] = from[k];  // may overlap
      pos += len;
    }
    prev = code;
  }
  return pos;
}

// ---------------------------------------------------------------- CCITT

// T.4's run-length codes, as bit strings: white and black terminating
// codes (runs 0-63), makeup codes (64-1728) and the extended makeup
// codes both colours share (1792-2560).
const char* const kWhiteTerm[64] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111",
    "10011", "10100", "00111", "01000", "001000", "000011", "110100",
    "110101", "101010", "101011", "0100111", "0001100", "0001000",
    "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011",
    "00010010", "00010011", "00010100", "00010101", "00010110", "00010111",
    "00101000", "00101001", "00101010", "00101011", "00101100", "00101101",
    "00000100", "00000101", "00001010", "00001011", "01010010", "01010011",
    "01010100", "01010101", "00100100", "00100101", "01011000", "01011001",
    "01011010", "01011011", "01001010", "01001011", "00110010", "00110011",
    "00110100"};
const char* const kWhiteMakeup[27] = {
    "11011", "10010", "010111", "0110111", "00110110", "00110111",
    "01100100", "01100101", "01101000", "01100111", "011001100",
    "011001101", "011010010", "011010011", "011010100", "011010101",
    "011010110", "011010111", "011011000", "011011001", "011011010",
    "011011011", "010011000", "010011001", "010011010", "011000",
    "010011011"};
const char* const kBlackTerm[64] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011",
    "000101", "000100", "0000100", "0000101", "0000111", "00000100",
    "00000111", "000011000", "0000010111", "0000011000", "0000001000",
    "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010",
    "000011001011", "000011001100", "000011001101", "000001101000",
    "000001101001", "000001101010", "000001101011", "000011010010",
    "000011010011", "000011010100", "000011010101", "000011010110",
    "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110",
    "000001010111", "000001100100", "000001100101", "000001010010",
    "000001010011", "000000100100", "000000110111", "000000111000",
    "000000100111", "000000101000", "000001011000", "000001011001",
    "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111"};
const char* const kBlackMakeup[27] = {
    "0000001111", "000011001000", "000011001001", "000001011011",
    "000000110011", "000000110100", "000000110101", "0000001101100",
    "0000001101101", "0000001001010", "0000001001011", "0000001001100",
    "0000001001101", "0000001110010", "0000001110011", "0000001110100",
    "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010",
    "0000001011011", "0000001100100", "0000001100101"};
const char* const kExtMakeup[13] = {
    "00000001000", "00000001100", "00000001101", "000000010010",
    "000000010011", "000000010100", "000000010101", "000000010110",
    "000000010111", "000000011100", "000000011101", "000000011110",
    "000000011111"};
const char* const kEol = "000000000001";
// T.4's 2-D mode codes: pass, horizontal, V0, VR1-3, VL1-3.
enum Mode { kNull, kPass, kHoriz, kV, kTerm, kMakeup, kEolCode };
const char* const kModeCodes[9] = {"0001", "001", "1", "011", "000011",
                                   "0000011", "010", "000010", "0000010"};
const int kModeDelta[9] = {0, 0, 0, 1, 2, 3, -1, -2, -3};

// A lookup of codes of up to `bits` bits, indexed as libtiff's fax
// decoder reads them: the code's first bit in the index's lowest bit.
struct Entry {
  uint8_t mode = kNull, width = 0;
  int16_t param = 0;
};
struct Table {
  int bits;
  std::vector<Entry> e;
  explicit Table(int b) : bits(b), e((size_t)1 << b) {}
  void add(const char* code, uint8_t mode, int param) {
    const int len = (int)strlen(code);
    int rev = 0;
    for (int i = 0; i < len; i++) rev |= (code[i] - '0') << i;
    for (int k = 0; k < 1 << (bits - len); k++) {
      Entry& x = e[(size_t)rev | ((size_t)k << len)];
      x.mode = mode;
      x.width = (uint8_t)len;
      x.param = (int16_t)param;
    }
  }
};

struct FaxTables {
  Table white{12}, black{13}, main{7};
  FaxTables() {
    for (int c = 0; c < 2; c++) {
      Table& t = c ? black : white;
      for (int r = 0; r < 64; r++)
        t.add((c ? kBlackTerm : kWhiteTerm)[r], kTerm, r);
      for (int m = 0; m < 27; m++)
        t.add((c ? kBlackMakeup : kWhiteMakeup)[m], kMakeup, 64 * (m + 1));
      for (int m = 0; m < 13; m++) t.add(kExtMakeup[m], kMakeup, 1792 + 64 * m);
      t.add(kEol, kEolCode, 0);
    }
    main.add(kModeCodes[0], kPass, 0);
    main.add(kModeCodes[1], kHoriz, 0);
    for (int k = 2; k < 9; k++) main.add(kModeCodes[k], kV, kModeDelta[k]);
  }
};

// libtiff's fax bit reader (tif_fax3.h's NeedBits8/NeedBits16, GetBits,
// ClrBits): bytes go through `map` (bit-reversing unless FillOrder is 2)
// into an accumulator read from its low bit; at the end of the data a
// reader that still holds bits is padded with zeros.
struct FaxBits {
  const uint8_t *start, *cp, *ep, *map;
  uint32_t acc = 0;
  int avail = 0;
  bool need8(int n) {
    if (avail < n) {
      if (cp >= ep) {
        if (avail == 0) return false;
        avail = n;
      } else {
        acc |= (uint32_t)map[*cp++] << avail;
        avail += 8;
      }
    }
    return true;
  }
  bool need16(int n) {
    if (avail < n) {
      if (cp >= ep) {
        if (avail == 0) return false;
        avail = n;
      } else {
        acc |= (uint32_t)map[*cp++] << avail;
        if ((avail += 8) < n) {
          if (cp >= ep) {
            avail = n;
          } else {
            acc |= (uint32_t)map[*cp++] << avail;
            avail += 8;
          }
        }
      }
    }
    return true;
  }
  int get(int n) const { return (int)(acc & ((1u << n) - 1)); }
  void clr(int n) {
    avail -= n;
    acc >>= n;
  }
  const Entry& look(const Table& t) {
    if (!(t.bits > 8 ? need16(t.bits) : need8(t.bits)))
      throw Error{"CCITT data ends early"};
    const Entry& e = t.e[get(t.bits)];
    clr(e.width);
    return e;
  }
};

// One run of a colour: makeup codes, then a terminating code.
int fax_run(FaxBits& b, const Table& t) {
  int run = 0;
  for (;;) {
    const Entry& e = b.look(t);
    if (e.mode == kTerm) return run + e.param;
    if (e.mode != kMakeup) throw Error{"bad CCITT code word"};
    run += e.param;
  }
}

// Decodes one strip or tile of CCITT data into rows of `width` pixels
// (1 for black, MSB first, rows padded to a byte).  `scheme`: 2
// (Modified Huffman, rows byte-aligned), 32771 (the same, rows aligned
// as libtiff aligns them to 16 bits), 3 (T.4: each row after an EOL,
// 2-D rows when bit 0 of `options` is set, each tagged by the bit after
// its EOL), 4 (T.6).  Anything libtiff would decode with a warning or a
// "bad code" error (a row of the wrong length, a bad code, uncompressed
// mode, an early EOL or EOFB, data that ends early) raises here.
void fax(const uint8_t* src, size_t n, size_t file_offset, int scheme,
         int options, bool lsb_first, int width, int rows, uint8_t* out) {
  static const FaxTables T;
  uint8_t rev[256];
  for (int i = 0; i < 256; i++) {
    int r = 0;
    for (int k = 0; k < 8; k++) r |= ((i >> k) & 1) << (7 - k);
    rev[i] = (uint8_t)(lsb_first ? i : r);
  }
  FaxBits b{src, src, src + n, rev};
  const size_t row_bytes = ((size_t)width + 7) / 8;
  // changing elements of the reference and the current row: the first
  // into black, then alternating; three sentinels at `width`
  std::vector<int> ref{width, width, width}, cur;
  cur.reserve(64);
  for (int y = 0; y < rows; y++) {
    bool two_d = scheme == 4;
    if (scheme == 3) {  // SYNC_EOL: to 11 zero bits, past fill, past the 1
      for (;;) {
        if (!b.need16(11)) throw Error{"CCITT data ends early"};
        if (b.get(11) == 0) break;
        b.clr(1);
      }
      for (;;) {
        if (!b.need8(8)) throw Error{"CCITT data ends early"};
        if (b.get(8)) break;
        b.clr(8);
      }
      while (b.get(1) == 0) b.clr(1);
      b.clr(1);
      if (options & 1) {
        if (!b.need8(1)) throw Error{"CCITT data ends early"};
        two_d = b.get(1) == 0;
        b.clr(1);
      }
    }
    cur.clear();
    int a0 = 0, colour = 0;
    // a run ends at `at`: a change of colour there, unless the row ends;
    // runs of zero length, which no encoder writes but the first white
    // one, raise (libtiff keeps them in its reference runs)
    auto run_to = [&](int at, bool may_be_empty) {
      if (at > width) throw Error{"CCITT row longer than the image"};
      if (at == a0 && !may_be_empty && at < width)
        throw Error{"zero-length CCITT run inside a row"};
      if (at < width) cur.push_back(at);
      a0 = at;
    };
    if (!two_d) {
      while (a0 < width) {
        run_to(a0 + fax_run(b, colour ? T.black : T.white), cur.empty() &&
               a0 == 0 && colour == 0);
        colour ^= 1;
      }
    } else {
      size_t bi = 0;
      bool first = true;
      // b1: the first change on the reference row past a0 (at or past
      // it before the row's first code) into the colour opposite a0's
      auto b1_at = [&]() {
        size_t i = bi > 1 ? bi - 2 : 0;
        if ((int)(i & 1) != colour) i++;
        while (first ? ref[i] < a0 : ref[i] <= a0) i += 2;
        bi = i;
        return i;
      };
      while (a0 < width) {
        const Entry& e = b.look(T.main);
        if (e.mode == kPass) {
          const int b2 = ref[b1_at() + 1];
          if (b2 > width) throw Error{"CCITT row longer than the image"};
          a0 = b2;
        } else if (e.mode == kHoriz) {
          const int r1 = fax_run(b, colour ? T.black : T.white);
          const int r2 = fax_run(b, colour ? T.white : T.black);
          run_to(a0 + r1, first && a0 == 0 && colour == 0);
          run_to(a0 + r2, false);
        } else if (e.mode == kV) {
          const int a1 = ref[b1_at()] + e.param;
          if (a1 < a0) throw Error{"bad CCITT vertical mode"};
          run_to(a1, first && a0 == 0 && colour == 0);
          colour ^= 1;
        } else {
          throw Error{"bad CCITT code word (or uncompressed mode)"};
        }
        first = false;
      }
    }
    // fill the row from its changes
    uint8_t* row = out + (size_t)y * row_bytes;
    memset(row, 0, row_bytes);
    for (size_t i = 0; i < cur.size(); i += 2) {
      const int x0 = cur[i], x1 = i + 1 < cur.size() ? cur[i + 1] : width;
      for (int x = x0; x < x1; x++) row[x >> 3] |= (uint8_t)(0x80 >> (x & 7));
    }
    ref = cur;
    ref.insert(ref.end(), 3, width);
    if (scheme == 2) {  // byte-aligned rows
      b.clr(b.avail & 7);
    } else if (scheme == 32771) {  // word-aligned, as libtiff aligns them
      b.clr(b.avail & 15);
      if (b.avail == 0 && ((file_offset + (size_t)(b.cp - b.start)) & 1))
        b.cp++;
    }
  }
}

// ThunderScan 4-bit data (tif_thunder.c's ThunderDecode, row by row, on
// a zeroed buffer): runs, 2- and 3-bit deltas and raw pixels.  A row
// that decodes to more or fewer than `width` pixels raises.
void thunder(const uint8_t* bp, size_t cc, int width, int rows,
             uint8_t* out) {
  static const int twobit[4] = {0, 1, 0, -1};
  static const int threebit[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  const size_t row_bytes = ((size_t)width + 1) / 2;
  memset(out, 0, row_bytes * rows);
  for (int y = 0; y < rows; y++) {
    uint8_t* op = out + (size_t)y * row_bytes;
    unsigned lastpixel = 0;
    long npixels = 0;
    const long maxpixels = width;
    auto set = [&](unsigned v) {
      lastpixel = v & 0xf;
      if (npixels < maxpixels) {
        if (npixels++ & 1)
          *op++ |= (uint8_t)lastpixel;
        else
          op[0] = (uint8_t)(lastpixel << 4);
      }
    };
    while (cc > 0 && npixels < maxpixels) {
      int n = *bp++, delta;
      cc--;
      switch (n & 0xc0) {
        case 0x00:  // a run of the last pixel
          if (npixels & 1) {
            op[0] |= (uint8_t)lastpixel;
            lastpixel = *op++;
            npixels++;
            n--;
          } else {
            lastpixel |= lastpixel << 4;
          }
          npixels += n;
          if (npixels <= maxpixels)
            for (; n > 0; n -= 2) *op++ = (uint8_t)lastpixel;
          if (n == -1) *--op &= 0xf0;
          lastpixel &= 0xf;
          break;
        case 0x40:  // three 2-bit deltas
          if ((delta = (n >> 4) & 3) != 2) set(lastpixel + twobit[delta]);
          if ((delta = (n >> 2) & 3) != 2) set(lastpixel + twobit[delta]);
          if ((delta = n & 3) != 2) set(lastpixel + twobit[delta]);
          break;
        case 0x80:  // two 3-bit deltas
          if ((delta = (n >> 3) & 7) != 4) set(lastpixel + threebit[delta]);
          if ((delta = n & 7) != 4) set(lastpixel + threebit[delta]);
          break;
        default:  // a raw pixel
          set((unsigned)n);
      }
    }
    if (npixels != maxpixels)
      throw Error{npixels < maxpixels ? "not enough ThunderScan data"
                                      : "too much ThunderScan data"};
  }
}

// SGILog (tif_luv.c) as libtiff's RGBA route reads it, in
// SGILOGDATAFMT_8BIT.  Compression 34676: each row's byte planes, high
// byte first, as runs (a byte >= 128: that minus 126 copies of the next
// byte) and literals (a count, then the bytes), OR-ed into the row's
// words; LogL's 16-bit words to grey (L16toGry), LogLuv's 32-bit words
// to RGB (Luv32toRGB: LogLuv32toXYZ, XYZtoRGB24).  Compression 34677:
// LogLuv's 24-bit words, 3 bytes each (Luv24toRGB: LogLuv24toXYZ, the
// (u', v') cell decoded through libtiff's uvcode.h table).  In double
// as libtiff, through the C library's exp and sqrt.

// libtiff's uvcode.h (generated 1997 by Greg Ward Larson, SGI): for
// each of the 163 rows of (u', v') cells of 0.0035, from v' = 0.01694,
// the first u' and the cells in the row and before it.
//
// Copyright (c) 1997 Greg Ward Larson
// Copyright (c) 1997 Silicon Graphics, Inc.
//
// Permission to use, copy, modify, distribute, and sell this software and
// its documentation for any purpose is hereby granted without fee,
// provided that (i) the above copyright notices and this permission
// notice appear in all copies of the software and related documentation,
// and (ii) the names of Greg Larson and Silicon Graphics may not be used
// in any advertising or publicity relating to the software without the
// specific, prior written permission of Greg Larson and Silicon Graphics.
//
// THE SOFTWARE IS PROVIDED "AS-IS" AND WITHOUT WARRANTY OF ANY KIND,
// EXPRESS, IMPLIED OR OTHERWISE, INCLUDING WITHOUT LIMITATION, ANY
// WARRANTY OF MERCHANTABILITY OR FITNESS FOR A PARTICULAR PURPOSE.
//
// IN NO EVENT SHALL GREG LARSON OR SILICON GRAPHICS BE LIABLE FOR ANY
// SPECIAL, INCIDENTAL, INDIRECT OR CONSEQUENTIAL DAMAGES OF ANY KIND, OR
// ANY DAMAGES WHATSOEVER RESULTING FROM LOSS OF USE, DATA OR PROFITS,
// WHETHER OR NOT ADVISED OF THE POSSIBILITY OF DAMAGE, AND ON ANY THEORY
// OF LIABILITY, ARISING OUT OF OR IN CONNECTION WITH THE USE OR
// PERFORMANCE OF THIS SOFTWARE.
struct UvRow {
  float ustart;
  short nus, ncum;
};
const UvRow kUvRow[163] = {
  {0.247663, 4, 0}, {0.243779, 6, 4}, {0.241684, 7, 10}, {0.237874, 9, 17},
  {0.235906, 10, 26}, {0.232153, 12, 36}, {0.228352, 14, 48},
  {0.226259, 15, 62}, {0.222371, 17, 77}, {0.220410, 18, 94},
  {0.214710, 21, 112}, {0.212714, 22, 133}, {0.210721, 23, 155},
  {0.204976, 26, 178}, {0.202986, 27, 204}, {0.199245, 29, 231},
  {0.195525, 31, 260}, {0.193560, 32, 291}, {0.189878, 34, 323},
  {0.186216, 36, 357}, {0.186216, 36, 393}, {0.182592, 38, 429},
  {0.179003, 40, 467}, {0.175466, 42, 507}, {0.172001, 44, 549},
  {0.172001, 44, 593}, {0.168612, 46, 637}, {0.168612, 46, 683},
  {0.163575, 49, 729}, {0.158642, 52, 778}, {0.158642, 52, 830},
  {0.158642, 52, 882}, {0.153815, 55, 934}, {0.153815, 55, 989},
  {0.149097, 58, 1044}, {0.149097, 58, 1102}, {0.142746, 62, 1160},
  {0.142746, 62, 1222}, {0.142746, 62, 1284}, {0.138270, 65, 1346},
  {0.138270, 65, 1411}, {0.138270, 65, 1476}, {0.132166, 69, 1541},
  {0.132166, 69, 1610}, {0.126204, 73, 1679}, {0.126204, 73, 1752},
  {0.126204, 73, 1825}, {0.120381, 77, 1898}, {0.120381, 77, 1975},
  {0.120381, 77, 2052}, {0.120381, 77, 2129}, {0.112962, 82, 2206},
  {0.112962, 82, 2288}, {0.112962, 82, 2370}, {0.107450, 86, 2452},
  {0.107450, 86, 2538}, {0.107450, 86, 2624}, {0.107450, 86, 2710},
  {0.100343, 91, 2796}, {0.100343, 91, 2887}, {0.100343, 91, 2978},
  {0.095126, 95, 3069}, {0.095126, 95, 3164}, {0.095126, 95, 3259},
  {0.095126, 95, 3354}, {0.088276, 100, 3449}, {0.088276, 100, 3549},
  {0.088276, 100, 3649}, {0.088276, 100, 3749}, {0.081523, 105, 3849},
  {0.081523, 105, 3954}, {0.081523, 105, 4059}, {0.081523, 105, 4164},
  {0.074861, 110, 4269}, {0.074861, 110, 4379}, {0.074861, 110, 4489},
  {0.074861, 110, 4599}, {0.068290, 115, 4709}, {0.068290, 115, 4824},
  {0.068290, 115, 4939}, {0.068290, 115, 5054}, {0.063573, 119, 5169},
  {0.063573, 119, 5288}, {0.063573, 119, 5407}, {0.063573, 119, 5526},
  {0.057219, 124, 5645}, {0.057219, 124, 5769}, {0.057219, 124, 5893},
  {0.057219, 124, 6017}, {0.050985, 129, 6141}, {0.050985, 129, 6270},
  {0.050985, 129, 6399}, {0.050985, 129, 6528}, {0.050985, 129, 6657},
  {0.044859, 134, 6786}, {0.044859, 134, 6920}, {0.044859, 134, 7054},
  {0.044859, 134, 7188}, {0.040571, 138, 7322}, {0.040571, 138, 7460},
  {0.040571, 138, 7598}, {0.040571, 138, 7736}, {0.036339, 142, 7874},
  {0.036339, 142, 8016}, {0.036339, 142, 8158}, {0.036339, 142, 8300},
  {0.032139, 146, 8442}, {0.032139, 146, 8588}, {0.032139, 146, 8734},
  {0.032139, 146, 8880}, {0.027947, 150, 9026}, {0.027947, 150, 9176},
  {0.027947, 150, 9326}, {0.023739, 154, 9476}, {0.023739, 154, 9630},
  {0.023739, 154, 9784}, {0.023739, 154, 9938}, {0.019504, 158, 10092},
  {0.019504, 158, 10250}, {0.019504, 158, 10408}, {0.016976, 161, 10566},
  {0.016976, 161, 10727}, {0.016976, 161, 10888}, {0.016976, 161, 11049},
  {0.012639, 165, 11210}, {0.012639, 165, 11375}, {0.012639, 165, 11540},
  {0.009991, 168, 11705}, {0.009991, 168, 11873}, {0.009991, 168, 12041},
  {0.009016, 170, 12209}, {0.009016, 170, 12379}, {0.009016, 170, 12549},
  {0.006217, 173, 12719}, {0.006217, 173, 12892}, {0.005097, 175, 13065},
  {0.005097, 175, 13240}, {0.005097, 175, 13415}, {0.003909, 177, 13590},
  {0.003909, 177, 13767}, {0.002340, 177, 13944}, {0.002389, 170, 14121},
  {0.001068, 164, 14291}, {0.001653, 157, 14455}, {0.000717, 150, 14612},
  {0.001614, 143, 14762}, {0.000270, 136, 14905}, {0.000484, 129, 15041},
  {0.001103, 123, 15170}, {0.001242, 115, 15293}, {0.001188, 109, 15408},
  {0.001011, 103, 15517}, {0.000709, 97, 15620}, {0.000301, 89, 15717},
  {0.002416, 82, 15806}, {0.003251, 76, 15888}, {0.003246, 69, 15964},
  {0.004141, 62, 16033}, {0.005963, 55, 16095}, {0.008839, 47, 16150},
  {0.010490, 40, 16197}, {0.016994, 31, 16237}, {0.023659, 21, 16268}};
const int kUvNdivs = 16289, kUvNvs = 163;
const float kUvSqsiz = 0.003500f, kUvVstart = 0.016940f;

double logl16_to_y(int p16) {
  const int le = p16 & 0x7fff;
  if (!le) return 0.;
  const double y = exp(M_LN2 / 256. * (le + .5) - M_LN2 * 64.);
  return !(p16 & 0x8000) ? y : -y;
}

uint8_t gamma2(double v) {
  return (uint8_t)((v <= 0.) ? 0 : (v >= 1.) ? 255 : (int)(256. * sqrt(v)));
}

// XYZtoRGB24 of the XYZ of luminance L and (u', v').
void luv_to_rgb(double L, double u, double v, uint8_t* o) {
  float xyz[3] = {0.f, 0.f, 0.f};
  if (L > 0.) {
    const double s = 1. / (6. * u - 16. * v + 12.);
    const double x = 9. * u * s, y = 4. * v * s;
    xyz[0] = (float)(x / y * L);
    xyz[1] = (float)L;
    xyz[2] = (float)((1. - x - y) / y * L);
  }
  o[0] = gamma2(2.690 * xyz[0] + -1.276 * xyz[1] + -0.414 * xyz[2]);
  o[1] = gamma2(-1.022 * xyz[0] + 1.978 * xyz[1] + 0.044 * xyz[2]);
  o[2] = gamma2(0.061 * xyz[0] + -0.224 * xyz[1] + 1.163 * xyz[2]);
}

// LogLuv24toXYZ's colour: uv_decode's binary search over kUvRow, the
// neutral point for a code past the table.
void uv_decode(int c, double* u, double* v) {
  if (c < 0 || c >= kUvNdivs) {
    *u = 0.210526316;
    *v = 0.473684211;
    return;
  }
  int lower = 0, upper = kUvNvs;
  while (upper - lower > 1) {
    const int vi = (lower + upper) >> 1;
    const int ui = c - kUvRow[vi].ncum;
    if (ui > 0) {
      lower = vi;
    } else if (ui < 0) {
      upper = vi;
    } else {
      lower = vi;
      break;
    }
  }
  const int ui = c - kUvRow[lower].ncum;
  *u = kUvRow[lower].ustart + (ui + .5) * kUvSqsiz;
  *v = kUvVstart + (lower + .5) * kUvSqsiz;
}

// LogLuv24: 3 bytes a pixel (10-bit log luminance, 14-bit colour
// cell), rows of `width`; data that ends before the last row raises.
void sgilog24(const uint8_t* bp, size_t cc, int width, int rows,
              uint8_t* out) {
  const size_t n = (size_t)width * rows;
  if (cc < 3 * n) throw Error{"not enough SGILog24 data"};
  for (size_t i = 0; i < n; i++, bp += 3) {
    const uint32_t p = (uint32_t)bp[0] << 16 | bp[1] << 8 | bp[2];
    const int l10 = p >> 14 & 0x3ff;
    const double L =
        l10 == 0 ? 0. : exp(M_LN2 / 64. * (l10 + .5) - M_LN2 * 12.);
    double u, v;
    uv_decode(p & 0x3fff, &u, &v);
    luv_to_rgb(L, u, v, out + 3 * i);
  }
}

void sgilog(const uint8_t* bp, size_t cc, int width, int rows, bool luv,
            uint8_t* out) {
  std::vector<uint32_t> tp((size_t)width);
  const int nbytes = luv ? 4 : 2;
  const long npixels = width;
  for (int y = 0; y < rows; y++) {
    std::fill(tp.begin(), tp.end(), 0u);
    for (int shft = 8 * (nbytes - 1); shft >= 0; shft -= 8) {
      long i = 0;
      while (i < npixels && cc > 0) {
        if (*bp >= 128) {  // a run
          if (cc < 2) break;
          int rc = *bp++ + (2 - 128);
          const uint32_t b = (uint32_t)*bp++ << shft;
          cc -= 2;
          while (rc-- && i < npixels) tp[i++] |= b;
        } else {  // literals; a count of 0 is a no-op
          int rc = *bp++;
          while (--cc && rc-- && i < npixels)
            tp[i++] |= (uint32_t)*bp++ << shft;
        }
      }
      if (i != npixels) throw Error{"not enough SGILog data"};
    }
    uint8_t* o = out + (size_t)y * width * (luv ? 3 : 1);
    for (long i = 0; i < npixels; i++) {
      if (!luv) {
        o[i] = gamma2(logl16_to_y((int16_t)tp[i]));
        continue;
      }
      const uint32_t p = tp[i];
      luv_to_rgb(logl16_to_y((int)p >> 16), 1. / 410. * ((p >> 8 & 0xff) + .5),
                 1. / 410. * ((p & 0xff) + .5), o + 3 * i);
    }
  }
}

}  // namespace

extern "C" {

// SGILog data of one strip or tile (`rows` rows of `width` pixels) as
// 8-bit grey (LogL, kind 0) or RGB (LogLuv, kind 1; LogLuv24, kind 2);
// returns 0, or 1 with the cause in err.
int mn_tiff_sgilog(const uint8_t* src, size_t n, int width, int rows,
                   int kind, uint8_t* out, char* err, int errlen) {
  try {
    if (kind == 2)
      sgilog24(src, n, width, rows, out);
    else
      sgilog(src, n, width, rows, kind == 1, out);
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
  }
  return 1;
}

// CCITT data of one strip or tile (see `fax`); `file_offset`, where the
// data starts in the file, places libtiff's 16-bit alignment.  Returns 0,
// or 1 with the cause in err.
int mn_tiff_fax(const uint8_t* src, size_t n, size_t file_offset, int scheme,
                int options, int fill_order, int width, int rows,
                uint8_t* out, char* err, int errlen) {
  try {
    fax(src, n, file_offset, scheme, options, fill_order == 2, width, rows,
        out);
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
  }
  return 1;
}

// ThunderScan data of one strip into rows of `width` 4-bit pixels;
// returns 0, or 1 with the cause in err.
int mn_tiff_thunder(const uint8_t* src, size_t n, int width, int rows,
                    uint8_t* out, char* err, int errlen) {
  try {
    thunder(src, n, width, rows, out);
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
  }
  return 1;
}

// TIFF LZW of one strip or tile into out (cap bytes, the strip's size);
// returns the bytes decoded, or -1 with the cause in err.
long mn_tiff_lzw(const uint8_t* src, size_t n, uint8_t* out, size_t cap,
                 char* err, int errlen) {
  try {
    const bool old_style = n >= 2 && src[0] == 0 && (src[1] & 1);
    return (long)lzw(src, n, 8, !old_style, !old_style, out, cap);
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
  }
  return -1;
}

// GIF LZW image data (the sub-blocks joined) into out (cap bytes, the
// frame's pixels); returns the bytes decoded, or -1.
long mn_gif_lzw(const uint8_t* src, size_t n, int min_bits, uint8_t* out,
                size_t cap, char* err, int errlen) {
  try {
    if (min_bits < 1 || min_bits > 11)
      throw Error{"bad LZW minimum code size"};
    return (long)lzw(src, n, min_bits, false, false, out, cap);
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
  }
  return -1;
}

// PackBits into out until it holds cap bytes; returns cap or -1.
long mn_packbits(const uint8_t* src, size_t n, uint8_t* out, size_t cap,
                 char* err, int errlen) {
  size_t i = 0, pos = 0;
  while (pos < cap) {
    if (i >= n) {
      set_err(err, errlen, "PackBits data ends early");
      return -1;
    }
    const int c = (int8_t)src[i++];
    if (c >= 0) {
      const size_t k = (size_t)c + 1;
      if (i + k > n) {
        set_err(err, errlen, "PackBits literal runs past the data");
        return -1;
      }
      if (pos + k > cap) {
        set_err(err, errlen, "PackBits literal overruns the strip");
        return -1;
      }
      memcpy(out + pos, src + i, k);
      i += k;
      pos += k;
    } else if (c != -128) {
      const size_t k = (size_t)(1 - c);
      if (i >= n) {
        set_err(err, errlen, "PackBits run past the data");
        return -1;
      }
      if (pos + k > cap) {
        set_err(err, errlen, "PackBits run overruns the strip");
        return -1;
      }
      memset(out + pos, src[i++], k);
      pos += k;
    }
  }
  return (long)pos;
}

// Undoes predictor 2 in place: rows of `row_samples` samples of `bytes`
// (1 or 2) bytes, `spp` per pixel, 16-bit ones in the file's byte order.
void mn_tiff_unpredict(uint8_t* buf, size_t rows, size_t row_samples,
                       int spp, int bytes, int big_endian) {
  for (size_t r = 0; r < rows; r++) {
    if (bytes == 1) {
      uint8_t* p = buf + r * row_samples;
      for (size_t i = spp; i < row_samples; i++) p[i] += p[i - spp];
    } else {
      uint8_t* p = buf + r * row_samples * 2;
      auto get = [&](size_t i) -> unsigned {
        return big_endian ? (p[2 * i] << 8) | p[2 * i + 1]
                          : p[2 * i] | (p[2 * i + 1] << 8);
      };
      for (size_t i = spp; i < row_samples; i++) {
        const unsigned v = (get(i) + get(i - spp)) & 0xFFFF;
        if (big_endian) {
          p[2 * i] = v >> 8;
          p[2 * i + 1] = v & 255;
        } else {
          p[2 * i] = v & 255;
          p[2 * i + 1] = v >> 8;
        }
      }
    }
  }
}

// BMP RLE8 (bpp 8) or RLE4 (bpp 4) into out (height rows of width
// indices, the first decoded row first).  Returns 0, or 1 with the cause
// in err where OpenCV refuses the file (a run past its row, data that
// ends before the image is done).
int mn_bmp_rle(const uint8_t* src, size_t n, int bpp, int width, int height,
               uint8_t* out, char* err, int errlen) {
  size_t i = 0;
  long y = 0;
  size_t line = 0;  // start of row y in out
  size_t x = 0;     // position in row y
  const size_t W = (size_t)width;
  auto byte = [&]() -> int {
    if (i >= n) throw Error{"RLE data ends before the end of the bitmap"};
    return src[i++];
  };
  // FillUniColor: count pixels of index 0 from (y, x), wrapping rows
  auto fill = [&](long count) {
    do {
      long room = (long)(W - x);
      long k = count < room ? count : room;
      if (k > 0) memset(out + line + x, 0, (size_t)k);
      count -= k > 0 ? k : 0;
      x += k > 0 ? (size_t)k : 0;
      if (x >= W) {
        x = 0;
        if (++y >= height) break;
        line = (size_t)y * W;
      }
    } while (count > 0);
  };
  try {
    if (bpp == 8) {
      int line_end_flag = 0;
      while (true) {
        const int len = byte(), code = byte();
        if (len != 0) {  // encoded run
          const long prev_y = y;
          if (x + (size_t)len > W) throw Error{"RLE8 run past its row"};
          memset(out + line + x, code, (size_t)len);
          x += len;
          if (x >= W) {
            x = 0;
            ++y;
            line = (size_t)y * W;
          }
          line_end_flag = (int)(y - prev_y);
          if (y >= height) break;
        } else if (code > 2) {  // absolute run
          if (x + (size_t)code > W)
            throw Error{"RLE8 absolute run past its row"};
          const size_t sz = (size_t)((code + 1) & ~1);
          if (i + sz > n)
            throw Error{"RLE data ends before the end of the bitmap"};
          memcpy(out + line + x, src + i, (size_t)code);
          i += sz;
          x += code;
          line_end_flag = 0;
        } else {
          long x_shift = (long)(W - x);
          long y_shift = height - y;
          if (code || !line_end_flag || x_shift < (long)W) {
            if (code == 2) {
              x_shift = byte();
              y_shift = byte();
            }
            if (code != 0) x_shift += y_shift * (long)W;
            if (y >= height) break;
            fill(x_shift);
            if (y >= height) break;
          }
          line_end_flag = 0;
          if (y >= height) break;
        }
      }
    } else {
      while (true) {
        const int len = byte(), code = byte();
        if (len != 0) {  // encoded run of two alternating indices
          if (x + (size_t)len > W) throw Error{"RLE4 run past its row"};
          for (int k = 0; k < len; k++)
            out[line + x + k] = (k & 1) ? (code & 15) : (code >> 4);
          x += len;
        } else if (code > 2) {  // absolute run
          if (x + (size_t)code > W)
            throw Error{"RLE4 absolute run past its row"};
          const size_t sz = (size_t)((((code + 1) >> 1) + 1) & ~1);
          if (i + sz > n)
            throw Error{"RLE data ends before the end of the bitmap"};
          for (int k = 0; k < code; k++) {
            const uint8_t b = src[i + (k >> 1)];
            out[line + x + k] = (k & 1) ? (b & 15) : (b >> 4);
          }
          i += sz;
          x += code;
        } else {
          // OpenCV 5.0 adds no rows here: end-of-bitmap ends the row as
          // end-of-line does, and a delta skips dx pixels, not dy rows
          long x_shift = (long)(W - x);
          if (code == 2) {
            x_shift = byte();
            byte();
          }
          fill(x_shift);
          if (y >= height) break;
        }
      }
    }
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return 1;
  }
  return 0;
}

// Radiance RGBE scanlines into out (height * width * 4 bytes); returns 0,
// or 1 with the cause in err where rgbe.cpp reports an error.
int mn_hdr_rle(const uint8_t* src, size_t n, int width, int height,
               uint8_t* out, char* err, int errlen) {
  const size_t W = (size_t)width, total = W * (size_t)height * 4;
  size_t i = 0, pos = 0;
  auto flat = [&](size_t at) {  // the rest of the image as flat RGBE
    if (i + (total - at) > n) throw Error{"RGBE data ends early"};
    memcpy(out + at, src + i, total - at);
  };
  try {
    if (width < 8 || width > 0x7fff) {
      flat(0);
      return 0;
    }
    for (int y = 0; y < height; y++) {
      if (i + 4 > n) throw Error{"RGBE data ends early"};
      const uint8_t* h = src + i;
      if (h[0] != 2 || h[1] != 2 || (h[2] & 0x80)) {
        flat(pos);
        return 0;
      }
      if ((size_t)((h[2] << 8) | h[3]) != W)
        throw Error{"wrong scanline width"};
      i += 4;
      for (int c = 0; c < 4; c++) {
        size_t x = 0;
        while (x < W) {
          if (i + 2 > n) throw Error{"RGBE data ends early"};
          size_t count = src[i];
          if (count > 128) {
            count -= 128;
            if (count == 0 || count > W - x) throw Error{"bad scanline data"};
            for (size_t k = 0; k < count; k++)
              out[pos + (x + k) * 4 + c] = src[i + 1];
            i += 2;
          } else {
            if (count == 0 || count > W - x) throw Error{"bad scanline data"};
            if (i + 1 + count > n) throw Error{"RGBE data ends early"};
            for (size_t k = 0; k < count; k++)
              out[pos + (x + k) * 4 + c] = src[i + 1 + k];
            i += 1 + count;
          }
          x += count;
        }
      }
      pos += W * 4;
    }
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return 1;
  }
  return 0;
}

}  // extern "C"

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
#include <cstdint>
#include <cstdio>
#include <cstring>

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

}  // namespace

extern "C" {

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

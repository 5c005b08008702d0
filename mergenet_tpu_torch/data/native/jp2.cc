// JPEG 2000 Part 1 codestream decoding for the port's `data/jp2.py`,
// written from ITU-T T.800 for the port, with OpenJPEG 2.5's arithmetic
// wherever it decides the bits that cv2.imread returns (OpenCV 5.0 reads
// JPEG 2000 through OpenJPEG 2.5.3; no OpenJPEG is vendored or linked):
//
// - tier 1 (T.800 Annex D): the MQ decoder (C.3, INITDEC/BYTEIN with an
//   artificial 0xFF 0xFF after each segment), the significance,
//   refinement and cleanup passes in stripes of 4 rows, BYPASS (raw
//   passes after the fourth bit-plane), RESET, TERMALL, VSC, PTERM and
//   SEGSYM; coefficients carry one fractional bit, so that a sample made
//   significant at bit-plane p holds 1.5 * 2^p and each refinement adds
//   or takes 2^(p-1) (OpenJPEG's reconstruction point);
// - RGN max-shift: |v| >= 2^s is shifted down by s, in that doubled scale;
// - tier 2 (Annex B): tag trees, inclusion, zero bit-planes, passes and
//   Lblock, segments (BYPASS, TERMALL), SOP/EPH, PPM/PPT packed headers,
//   the five progressions and POC (main header POCs first, then the
//   tile's, as OpenJPEG appends them), each packet decoded once;
// - dequantisation: reversible v / 2 (truncating); irreversible
//   float(v) * (0.5f * step), step = (1 + mant / 2048) * 2^(prec - expn)
//   in double, cast to float (no per-band gain: OpenJPEG's decoder
//   multiplies high-pass samples by 2 / K instead);
// - inverse DWT, rows then columns per level: 5/3 in integers with the
//   lifting phase taken from the parity of the resolution's origin (a
//   lone odd sample is halved), 9/7 in float with OpenJPEG's constants
//   and step order (opj_v8dwt_decode: lows * K, highs * 1.625732422f,
//   then delta, gamma, beta, alpha as w += (l + r) * c; a lone sample
//   is left as it is);
// - RCT / ICT (ICT in float as opj_mct_decode_real orders it), the DC
//   level shift and the clamp to the precision, the float samples
//   rounded by lrintf (half to even).
//
// Float code must not be contracted into fused multiply-adds: the
// library is built with -ffp-contract=off and no -march (SSE2 on x86-64),
// as `data/jp2.py`'s CXX_FLAGS say.
//
// What OpenJPEG refuses in its strict mode is refused here: truncated
// tile-parts, segments past the tile's data, markers out of place or of
// bad sizes.  HTJ2K (code-block style 0x40, the CAP marker) and the
// Part 2 markers (MCT, MCC, MCO, CBD, ATK-style Rsiz) are reported as
// not yet read.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Fail {
  std::string msg;
};

[[noreturn]] void fail(const std::string& m) { throw Fail{m}; }

const int NOT_YET = 2;  // return code: a feature the port does not read yet

struct NotYet {
  std::string msg;
};

inline uint32_t ceildiv(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a + b - 1) / b);
}
inline int32_t int_ceildivpow2(int32_t a, int32_t b) {
  return (int32_t)(((int64_t)a + ((int64_t)1 << b) - 1) >> b);
}
inline int32_t int64_ceildivpow2(int64_t a, int32_t b) {
  return (int32_t)((a + ((int64_t)1 << b) - 1) >> b);
}
inline int32_t int_floordivpow2(int32_t a, int32_t b) { return a >> b; }

// ------------------------------------------------------------- parameters

struct StepSize {
  int expn = 0, mant = 0;
};

const int MAXRLVLS = 33;
const int MAXBANDS = 3 * MAXRLVLS - 2;

struct TCCP {
  uint32_t csty = 0;
  uint32_t numres = 0;
  uint32_t cblkw = 0, cblkh = 0;
  uint32_t cblksty = 0;
  uint32_t qmfbid = 0;
  uint32_t qntsty = 0;
  uint32_t numgbits = 0;
  StepSize steps[MAXBANDS];
  uint32_t roishift = 0;
  uint32_t prcw[MAXRLVLS], prch[MAXRLVLS];
  int32_t dc_shift = 0;
};

struct Poc {
  uint32_t resno0, compno0, layno1, resno1, compno1, prg;
};

struct TCP {
  uint32_t csty = 0, prg = 0, numlayers = 0, mct = 0;
  std::vector<TCCP> tccps;
  std::vector<Poc> pocs;
  // PPT markers by Zppt
  std::vector<std::vector<uint8_t>> ppt_markers;
  std::vector<bool> ppt_have;
  bool ppt = false;
  std::vector<uint8_t> ppt_data;
  size_t ppt_pos = 0;
  std::vector<uint8_t> data;
  bool has_data = false;  // a tile-part with an SOD was read
  int32_t cur_part = -1;
  uint32_t nb_parts = 0;
  bool decoded = false;
};

struct Comp {
  uint32_t prec = 0, sgnd = 0, dx = 1, dy = 1;
  uint32_t x0 = 0, y0 = 0, w = 0, h = 0;
  uint32_t resno_decoded = 0;
  std::vector<int32_t> data;
};

// ---------------------------------------------------------------- bit I/O

struct Bio {
  const uint8_t* start;
  const uint8_t* end;
  const uint8_t* bp;
  uint32_t buf = 0, ct = 0;
  Bio(const uint8_t* b, size_t n) : start(b), end(b + n), bp(b) {}
  void bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (bp >= end) return;
    buf |= *bp++;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    ct--;
    return (buf >> ct) & 1;
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; i--) v |= bit() << i;
    return v;
  }
  void inalign() {
    if ((buf & 0xff) == 0xff) bytein();
    ct = 0;
  }
  size_t numbytes() const { return (size_t)(bp - start); }
};

// --------------------------------------------------------------- tag tree

struct TagTree {
  struct Node {
    int parent;
    int32_t value, low;
  };
  std::vector<Node> nodes;
  void build(uint32_t w, uint32_t h) {
    nodes.clear();
    if (w == 0 || h == 0) return;
    std::vector<uint32_t> ws, hs;
    uint32_t cw = w, ch = h;
    size_t total = 0;
    for (;;) {
      ws.push_back(cw);
      hs.push_back(ch);
      total += (size_t)cw * ch;
      if (cw * ch <= 1) break;
      cw = (cw + 1) >> 1;
      ch = (ch + 1) >> 1;
    }
    nodes.assign(total, Node{-1, 999, 0});
    size_t base = 0;
    for (size_t l = 0; l + 1 < ws.size(); l++) {
      size_t next = base + (size_t)ws[l] * hs[l];
      for (uint32_t y = 0; y < hs[l]; y++)
        for (uint32_t x = 0; x < ws[l]; x++)
          nodes[base + (size_t)y * ws[l] + x].parent =
              (int)(next + (size_t)(y >> 1) * ws[l + 1] + (x >> 1));
      base = next;
    }
  }
  uint32_t decode(Bio& bio, uint32_t leaf, int32_t threshold) {
    int stk[40];
    int sp = 0;
    int node = (int)leaf;
    while (nodes[node].parent >= 0) {
      stk[sp++] = node;
      node = nodes[node].parent;
    }
    int32_t low = 0;
    for (;;) {
      Node& n = nodes[node];
      if (low > n.low)
        n.low = low;
      else
        low = n.low;
      while (low < threshold && low < n.value) {
        if (bio.bit())
          n.value = low;
        else
          ++low;
      }
      n.low = low;
      if (sp == 0) break;
      node = stk[--sp];
    }
    return nodes[node].value < threshold ? 1 : 0;
  }
};

// ------------------------------------------------------------- tile layout

struct Seg {
  uint32_t len = 0, numpasses = 0, maxpasses = 0, newlen = 0,
           numnewpasses = 0;
};

struct Cblk {
  int32_t x0, y0, x1, y1;
  uint32_t numbps = 0, numlenbits = 0, numsegs = 0, numnewpasses = 0;
  std::vector<Seg> segs;
  std::vector<uint8_t> data;
};

struct Precinct {
  int32_t x0, y0, x1, y1;
  uint32_t cw = 0, ch = 0;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};

struct Band {
  uint32_t bandno;
  int32_t x0, y0, x1, y1;
  float stepsize;
  int32_t numbps;
  std::vector<Precinct> precs;
  bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Res {
  int32_t x0, y0, x1, y1;
  uint32_t pw, ph, pdx, pdy, numbands;
  Band bands[3];
};

struct TileComp {
  int32_t x0, y0, x1, y1;
  uint32_t numres;
  std::vector<Res> res;
  std::vector<int32_t> idata;  // reversible
  std::vector<float> fdata;    // irreversible
};

// -------------------------------------------------------------- MQ decoder

struct QeState {
  uint32_t qe;
  uint8_t nmps, nlps, sw;
};

const QeState QE[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

enum { CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18,
       NCTX = 19 };

struct MQ {
  const uint8_t* bp;
  uint32_t a, c, ct;
  uint8_t state[NCTX], mps[NCTX];
  void reset_states() {
    for (int i = 0; i < NCTX; i++) state[i] = 0, mps[i] = 0;
    state[CTX_UNI] = 46;
    state[CTX_AGG] = 3;
    state[CTX_ZC] = 4;
  }
  __attribute__((always_inline)) inline void bytein() {
    if (*bp == 0xff) {
      if (bp[1] > 0x8f) {
        c += 0xff00;
        ct = 8;
      } else {
        bp++;
        c += (uint32_t)(*bp) << 9;
        ct = 7;
      }
    } else {
      bp++;
      c += (uint32_t)(*bp) << 8;
      ct = 8;
    }
  }
  // `p` is followed by 0xFF 0xFF at p + len
  void init(const uint8_t* p, uint32_t len) {
    bp = p;
    if (len == 0)
      c = 0xffu << 16;
    else
      c = (uint32_t)(*bp) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void raw_init(const uint8_t* p) {
    bp = p;
    c = 0;
    ct = 0;
  }
  __attribute__((always_inline)) inline void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      ct--;
    } while (a < 0x8000);
  }
  __attribute__((always_inline)) inline uint32_t decode(int cx) {
    const QeState& s = QE[state[cx]];
    uint32_t d;
    a -= s.qe;
    if ((c >> 16) < s.qe) {
      if (a < s.qe) {
        a = s.qe;
        d = mps[cx];
        state[cx] = s.nmps;
      } else {
        a = s.qe;
        d = 1 - mps[cx];
        if (s.sw) mps[cx] = 1 - mps[cx];
        state[cx] = s.nlps;
      }
      renorm();
    } else {
      c -= s.qe << 16;
      if ((a & 0x8000) == 0) {
        if (a < s.qe) {
          d = 1 - mps[cx];
          if (s.sw) mps[cx] = 1 - mps[cx];
          state[cx] = s.nlps;
        } else {
          d = mps[cx];
          state[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
  inline uint32_t raw() {
    if (ct == 0) {
      if (c == 0xff) {
        if (*bp > 0x8f) {
          c = 0xff;
          ct = 8;
        } else {
          c = *bp;
          bp++;
          ct = 7;
        }
      } else {
        c = *bp;
        bp++;
        ct = 8;
      }
    }
    ct--;
    return (c >> ct) & 1;
  }
};

// ------------------------------------------------------------------ tier 1

// per-sample flags: the significance of the 8 neighbours, the signs of
// the 4 direct ones, and the sample's own state; a sample that becomes
// significant updates its neighbours' flags, so that every context is a
// table lookup (the layout of OpenJPEG's t1 flags, not its bits)
enum : uint16_t {
  NB_NW = 1, NB_N = 2, NB_NE = 4, NB_W = 8, NB_E = 16, NB_SW = 32, NB_S = 64,
  NB_SE = 128, NEG_N = 256, NEG_S = 512, NEG_W = 1024, NEG_E = 2048,
  SIG = 4096, VISITED = 8192, REFINED = 16384, NEG = 32768
};
const uint16_t NB_ALL = 255, NB_SOUTH = NB_SW | NB_S | NB_SE;

struct Luts {
  uint8_t zc[4][256];
  uint8_t sc[256];  // context | xor bit << 7, indexed by the 4 direct
                    // neighbours' significance and signs (N S W E)
  Luts() {
    for (int o = 0; o < 4; o++)
      for (int m = 0; m < 256; m++) {
        int hh = !!(m & NB_W) + !!(m & NB_E);
        int vv = !!(m & NB_N) + !!(m & NB_S);
        int dd = !!(m & NB_NW) + !!(m & NB_NE) + !!(m & NB_SW) + !!(m & NB_SE);
        if (o == 1) std::swap(hh, vv);  // HL: vertical neighbours lead
        int n;
        if (o == 3) {
          int hv = hh + vv;
          if (dd >= 3)
            n = 8;
          else if (dd == 2)
            n = hv >= 1 ? 7 : 6;
          else if (dd == 1)
            n = hv >= 2 ? 5 : hv == 1 ? 4 : 3;
          else
            n = hv >= 2 ? 2 : hv == 1 ? 1 : 0;
        } else {
          if (hh == 2)
            n = 8;
          else if (hh == 1)
            n = vv >= 1 ? 7 : dd >= 1 ? 6 : 5;
          else if (vv == 2)
            n = 4;
          else if (vv == 1)
            n = 3;
          else
            n = dd >= 2 ? 2 : dd == 1 ? 1 : 0;
        }
        zc[o][m] = (uint8_t)n;
      }
    for (int m = 0; m < 256; m++) {
      // bits: sig N S W E (0-3), neg N S W E (4-7)
      auto c = [m](int i) { return (m >> i) & 1 ? ((m >> (i + 4)) & 1 ? -1 : 1) : 0; };
      int hc = c(2) + c(3), vc = c(0) + c(1);
      hc = hc > 0 ? 1 : hc < 0 ? -1 : 0;
      vc = vc > 0 ? 1 : vc < 0 ? -1 : 0;
      int xb = 0;
      if (hc < 0) {
        hc = -hc;
        vc = -vc;
        xb = 1;
      } else if (hc == 0 && vc < 0) {
        vc = -vc;
        xb = 1;
      }
      int ctx = hc == 0 ? (vc == 0 ? 0 : 1) : 3 + vc;
      sc[m] = (uint8_t)(ctx | xb << 7);
    }
  }
};
const Luts LUTS;

struct T1 {
  uint32_t w = 0, h = 0, stride = 0;
  std::vector<uint16_t> st;  // (h + 2) x (w + 2), border of 0
  std::vector<int32_t> data;
  MQ mq;
  uint32_t orient = 0;
  bool vsc = false;

  inline uint16_t* at(uint32_t x, uint32_t y) {
    return &st[(size_t)(y + 1) * stride + x + 1];
  }
  // the neighbour bits of (x, y): with VSC the row below a stripe's
  // last row counts as insignificant
  inline uint32_t nb(const uint16_t* p, uint32_t y) const {
    uint32_t f = *p;
    if (vsc && (y & 3) == 3) f &= ~(uint32_t)(NB_SOUTH | NEG_S);
    return f;
  }
  inline int zc_ctx(uint32_t f) const {
    return CTX_ZC + LUTS.zc[orient][f & NB_ALL];
  }
  inline int sc_ctx(uint32_t f, uint32_t& xorbit) const {
    uint32_t m = (f & NB_N ? 1 : 0) | (f & NB_S ? 2 : 0) | (f & NB_W ? 4 : 0) |
                 (f & NB_E ? 8 : 0) | ((f >> 8) & 0xf) << 4;
    uint8_t v = LUTS.sc[m];
    xorbit = v >> 7;
    return CTX_SC + (v & 0x7f);
  }
  inline void set_sig(uint16_t* p, uint32_t x, uint32_t y, uint32_t neg,
                      int32_t val) {
    const long s = (long)stride;
    *p |= SIG | (neg ? NEG : 0);
    p[-s - 1] |= NB_SE;
    p[-s] |= NB_S | (neg ? NEG_S : 0);
    p[-s + 1] |= NB_SW;
    p[-1] |= NB_E | (neg ? NEG_E : 0);
    p[1] |= NB_W | (neg ? NEG_W : 0);
    p[s - 1] |= NB_NE;
    p[s] |= NB_N | (neg ? NEG_N : 0);
    p[s + 1] |= NB_NW;
    data[(size_t)y * w + x] = neg ? -val : val;
  }

  void sigpass(int bpno, bool raw) {
    MQ m = mq;  // in registers: stores to `data` cannot alias it
    int32_t one = 1 << bpno, half = one >> 1, oph = one | half;
    for (uint32_t k = 0; k < h; k += 4) {
      uint32_t yend = std::min(k + 4, h);
      for (uint32_t x = 0; x < w; x++) {
        uint16_t* p = at(x, k);
        for (uint32_t y = k; y < yend; y++, p += stride) {
          if (*p & (SIG | VISITED)) continue;
          uint32_t f = nb(p, y);
          if (!(f & NB_ALL)) continue;
          if (raw) {
            if (m.raw()) set_sig(p, x, y, m.raw(), oph);
          } else if (m.decode(zc_ctx(f))) {
            uint32_t xb;
            int cx = sc_ctx(f, xb);
            set_sig(p, x, y, m.decode(cx) ^ xb, oph);
          }
          *p |= VISITED;
        }
      }
    }
    mq = m;
  }
  void refpass(int bpno, bool raw) {
    MQ m = mq;  // in registers: stores to `data` cannot alias it
    int32_t poshalf = (1 << bpno) >> 1;
    for (uint32_t k = 0; k < h; k += 4) {
      uint32_t yend = std::min(k + 4, h);
      for (uint32_t x = 0; x < w; x++) {
        uint16_t* p = at(x, k);
        for (uint32_t y = k; y < yend; y++, p += stride) {
          if ((*p & (SIG | VISITED)) != SIG) continue;
          uint32_t v;
          if (raw)
            v = m.raw();
          else {
            int cx = (*p & REFINED) ? CTX_MAG + 2
                     : (nb(p, y) & NB_ALL) ? CTX_MAG + 1 : CTX_MAG;
            v = m.decode(cx);
          }
          int32_t& d = data[(size_t)y * w + x];
          d += (v ^ (uint32_t)(d < 0)) ? poshalf : -poshalf;
          *p |= REFINED;
        }
      }
    }
    mq = m;
  }
  void clnpass(int bpno, bool segsym) {
    MQ m = mq;  // in registers: stores to `data` cannot alias it
    int32_t one = 1 << bpno, half = one >> 1, oph = one | half;
    for (uint32_t k = 0; k < h; k += 4) {
      uint32_t yend = std::min(k + 4, h);
      for (uint32_t x = 0; x < w; x++) {
        uint16_t* p = at(x, k);
        uint32_t y = k;
        if (k + 4 <= h) {
          const uint16_t mask = SIG | VISITED | NB_ALL;
          bool run = !(p[0] & mask) && !(p[stride] & mask) &&
                     !(p[2 * stride] & mask) &&
                     !(nb(p + 3 * stride, k + 3) & mask);
          if (run) {
            if (!m.decode(CTX_AGG)) continue;
            uint32_t r = m.decode(CTX_UNI);
            r = (r << 1) | m.decode(CTX_UNI);
            y = k + r;
            p += r * stride;
            uint32_t xb;
            int cx = sc_ctx(nb(p, y), xb);
            set_sig(p, x, y, m.decode(cx) ^ xb, oph);
            y++;
            p += stride;
          }
        }
        for (; y < yend; y++, p += stride) {
          if (*p & (SIG | VISITED)) continue;
          uint32_t f = nb(p, y);
          if (m.decode(zc_ctx(f))) {
            uint32_t xb;
            int cx = sc_ctx(f, xb);
            set_sig(p, x, y, m.decode(cx) ^ xb, oph);
          }
        }
      }
    }
    for (uint32_t y = 0; y < h; y++) {
      uint16_t* p = at(0, y);
      for (uint32_t x = 0; x < w; x++) p[x] &= (uint16_t)~VISITED;
    }
    if (segsym) {
      for (int i = 0; i < 4; i++) m.decode(CTX_UNI);
    }
    mq = m;
  }
};

// code-block styles (PTERM, 0x10, changes nothing in decoding)
const uint32_t CBLKSTY_LAZY = 0x01, CBLKSTY_RESET = 0x02,
               CBLKSTY_TERMALL = 0x04, CBLKSTY_VSC = 0x08,
               CBLKSTY_SEGSYM = 0x20, CBLKSTY_HT = 0x40;

// decodes one code-block into t1.data (w x h); false: OpenJPEG's failure
bool decode_cblk(T1& t1, Cblk& cb, uint32_t orient, uint32_t roishift,
                 uint32_t cblksty) {
  uint32_t w = (uint32_t)(cb.x1 - cb.x0), h = (uint32_t)(cb.y1 - cb.y0);
  t1.w = w;
  t1.h = h;
  t1.stride = w + 2;
  t1.st.assign((size_t)(w + 2) * (h + 2), 0);
  t1.data.assign((size_t)w * h, 0);
  t1.orient = orient;
  t1.vsc = (cblksty & CBLKSTY_VSC) != 0;
  t1.mq.reset_states();
  int32_t bpno_plus_one = (int32_t)(roishift + cb.numbps);
  if (bpno_plus_one >= 31) return false;
  uint32_t passtype = 2;
  // the code-block's data with room for the artificial marker
  std::vector<uint8_t>& buf = cb.data;
  size_t total = buf.size();
  buf.resize(total + 2);
  size_t index = 0;
  for (uint32_t segno = 0; segno < cb.numsegs; segno++) {
    Seg& seg = cb.segs[segno];
    bool raw = bpno_plus_one <= (int32_t)cb.numbps - 4 && passtype < 2 &&
               (cblksty & CBLKSTY_LAZY);
    uint8_t save0 = buf[index + seg.len], save1 = buf[index + seg.len + 1];
    buf[index + seg.len] = 0xff;
    buf[index + seg.len + 1] = 0xff;
    if (raw)
      t1.mq.raw_init(&buf[index]);
    else
      t1.mq.init(&buf[index], seg.len);
    for (uint32_t passno = 0; passno < seg.numpasses && bpno_plus_one >= 1;
         passno++) {
      switch (passtype) {
        case 0:
          t1.sigpass(bpno_plus_one, raw);
          break;
        case 1:
          t1.refpass(bpno_plus_one, raw);
          break;
        case 2:
          t1.clnpass(bpno_plus_one, (cblksty & CBLKSTY_SEGSYM) != 0);
          break;
      }
      if ((cblksty & CBLKSTY_RESET) && !raw) t1.mq.reset_states();
      if (++passtype == 3) {
        passtype = 0;
        bpno_plus_one--;
      }
    }
    buf[index + seg.len] = save0;
    buf[index + seg.len + 1] = save1;
    index += seg.len;
  }
  buf.resize(total);
  return true;
}

// --------------------------------------------------------------- wavelets

// 5/3 inverse in place on a row `a` (sn lows, then dn highs), cas =
// the parity of its first sample
void idwt53(int32_t* a, int32_t sn, int32_t dn, int cas,
            std::vector<int32_t>& tmp) {
  int32_t n = sn + dn;
  if (cas == 0) {
    if (n <= 1) return;
  } else {
    if (n == 1) {
      a[0] /= 2;
      return;
    }
  }
  tmp.resize(n);
  // interleave: lows at positions of parity 0 (k + cas even)
  for (int32_t j = 0; j < sn; j++) tmp[2 * j + cas] = a[j];
  for (int32_t j = 0; j < dn; j++) tmp[2 * j + 1 - cas] = a[sn + j];
  auto refl = [n](int32_t k) {
    if (k < 0) return -k;
    if (k >= n) return 2 * (n - 1) - k;
    return k;
  };
  // lows: X = Y - floor((left + right + 2) / 4)
  for (int32_t k = cas; k < n; k += 2)
    tmp[k] -= (tmp[refl(k - 1)] + tmp[refl(k + 1)] + 2) >> 2;
  for (int32_t k = 1 - cas; k < n; k += 2)
    tmp[k] += (tmp[refl(k - 1)] + tmp[refl(k + 1)]) >> 1;
  for (int32_t k = 0; k < n; k++) a[k] = tmp[k];
}

const float DWT_ALPHA = -1.586134342f;
const float DWT_BETA = -0.052980118f;
const float DWT_GAMMA = 0.882911075f;
const float DWT_DELTA = 0.443506852f;
const float DWT_K = 1.230174105f;
const float DWT_TWO_INVK = 1.625732422f;

// OpenJPEG's opj_v8dwt_decode_step2 for one signal: w[i] (at stride 2
// from `w`) += (l + r) * c, the last one doubled where its right
// neighbour is missing
inline void step2(float* fl, float* fw, uint32_t end, uint32_t m, float c) {
  uint32_t imax = std::min(end, m);
  for (uint32_t i = 0; i < imax; ++i) {
    fw[-1] = fw[-1] + ((fl[0] + fw[0]) * c);
    fl = fw;
    fw += 2;
  }
  if (m < end) {
    c += c;
    fw[-1] = fw[-1] + fl[0] * c;
  }
}

// the 9/7 inverse on a row, as opj_v8dwt_decode
void idwt97(float* a, int32_t sn, int32_t dn, int cas,
            std::vector<float>& tmp) {
  int32_t ia, ib;
  if (cas == 0) {
    if (!(dn > 0 || sn > 1)) return;
    ia = 0;
    ib = 1;
  } else {
    if (!(sn > 0 || dn > 1)) return;
    ia = 1;
    ib = 0;
  }
  int32_t n = sn + dn;
  tmp.assign((size_t)n + 2, 0.0f);
  float* wv = tmp.data();
  for (int32_t j = 0; j < sn; j++) wv[2 * j + cas] = a[j];
  for (int32_t j = 0; j < dn; j++) wv[2 * j + 1 - cas] = a[sn + j];
  for (int32_t i = 0; i < sn; i++) wv[ia + 2 * i] = wv[ia + 2 * i] * DWT_K;
  for (int32_t i = 0; i < dn; i++)
    wv[ib + 2 * i] = wv[ib + 2 * i] * DWT_TWO_INVK;
  step2(wv + ib, wv + ia + 1, (uint32_t)sn,
        (uint32_t)std::min(sn, dn - ia), -DWT_DELTA);
  step2(wv + ia, wv + ib + 1, (uint32_t)dn,
        (uint32_t)std::min(dn, sn - ib), -DWT_GAMMA);
  step2(wv + ib, wv + ia + 1, (uint32_t)sn,
        (uint32_t)std::min(sn, dn - ia), -DWT_BETA);
  step2(wv + ia, wv + ib + 1, (uint32_t)dn,
        (uint32_t)std::min(dn, sn - ib), -DWT_ALPHA);
  for (int32_t k = 0; k < n; k++) a[k] = wv[k];
}

// the vertical pass of a level on whole rows: the same operations per
// sample as idwt53 / idwt97 on each column, in an order that reads rows
void vert53(int32_t* a, size_t w, int32_t rw, int32_t sn, int32_t dn, int cas,
            std::vector<int32_t>& tmp) {
  int32_t n = sn + dn;
  if (cas == 0) {
    if (n <= 1) return;
  } else if (n == 1) {
    for (int32_t i = 0; i < rw; i++) a[i] /= 2;
    return;
  }
  tmp.resize((size_t)n * rw);
  for (int32_t j = 0; j < sn; j++)
    std::memcpy(&tmp[(size_t)(2 * j + cas) * rw], a + (size_t)j * w,
                sizeof(int32_t) * rw);
  for (int32_t j = 0; j < dn; j++)
    std::memcpy(&tmp[(size_t)(2 * j + 1 - cas) * rw], a + (size_t)(sn + j) * w,
                sizeof(int32_t) * rw);
  auto refl = [n](int32_t k) {
    if (k < 0) return -k;
    if (k >= n) return 2 * (n - 1) - k;
    return k;
  };
  for (int32_t k = cas; k < n; k += 2) {
    int32_t* r = &tmp[(size_t)k * rw];
    const int32_t* l = &tmp[(size_t)refl(k - 1) * rw];
    const int32_t* u = &tmp[(size_t)refl(k + 1) * rw];
    for (int32_t i = 0; i < rw; i++) r[i] -= (l[i] + u[i] + 2) >> 2;
  }
  for (int32_t k = 1 - cas; k < n; k += 2) {
    int32_t* r = &tmp[(size_t)k * rw];
    const int32_t* l = &tmp[(size_t)refl(k - 1) * rw];
    const int32_t* u = &tmp[(size_t)refl(k + 1) * rw];
    for (int32_t i = 0; i < rw; i++) r[i] += (l[i] + u[i]) >> 1;
  }
  for (int32_t k = 0; k < n; k++)
    std::memcpy(a + (size_t)k * w, &tmp[(size_t)k * rw], sizeof(int32_t) * rw);
}

void vert97(float* a, size_t w, int32_t rw, int32_t sn, int32_t dn, int cas,
            std::vector<float>& tmp) {
  int32_t ia, ib;
  if (cas == 0) {
    if (!(dn > 0 || sn > 1)) return;
    ia = 0;
    ib = 1;
  } else {
    if (!(sn > 0 || dn > 1)) return;
    ia = 1;
    ib = 0;
  }
  int32_t n = sn + dn;
  tmp.assign((size_t)(n + 2) * rw, 0.0f);
  float* wv = tmp.data();
  for (int32_t j = 0; j < sn; j++)
    std::memcpy(wv + (size_t)(2 * j + cas) * rw, a + (size_t)j * w,
                sizeof(float) * rw);
  for (int32_t j = 0; j < dn; j++)
    std::memcpy(wv + (size_t)(2 * j + 1 - cas) * rw, a + (size_t)(sn + j) * w,
                sizeof(float) * rw);
  for (int32_t i = 0; i < sn; i++) {
    float* r = wv + (size_t)(ia + 2 * i) * rw;
    for (int32_t x = 0; x < rw; x++) r[x] = r[x] * DWT_K;
  }
  for (int32_t i = 0; i < dn; i++) {
    float* r = wv + (size_t)(ib + 2 * i) * rw;
    for (int32_t x = 0; x < rw; x++) r[x] = r[x] * DWT_TWO_INVK;
  }
  // as step2(l = wv + b, w = wv + a + 1): updates rows a + 2i from rows
  // a + 2i - 1 (or b, the first, where a = 0) and a + 2i + 1
  auto step = [&](int32_t tgt, int32_t other, uint32_t end, uint32_t m,
                  float c) {
    uint32_t imax = std::min(end, m);
    for (uint32_t i = 0; i < imax; ++i) {
      int32_t p = tgt + 2 * (int32_t)i;
      float* r = wv + (size_t)p * rw;
      const float* l = wv + (size_t)(i == 0 ? other : p - 1) * rw;
      const float* u = wv + (size_t)(p + 1) * rw;
      for (int32_t x = 0; x < rw; x++) r[x] = r[x] + ((l[x] + u[x]) * c);
    }
    if (m < end) {
      int32_t p = tgt + 2 * (int32_t)m;
      float* r = wv + (size_t)p * rw;
      const float* l = wv + (size_t)(m == 0 ? other : p - 1) * rw;
      float cc = c + c;
      for (int32_t x = 0; x < rw; x++) r[x] = r[x] + l[x] * cc;
    }
  };
  step(ia, ib, (uint32_t)sn, (uint32_t)std::min(sn, dn - ia), -DWT_DELTA);
  step(ib, ia, (uint32_t)dn, (uint32_t)std::min(dn, sn - ib), -DWT_GAMMA);
  step(ia, ib, (uint32_t)sn, (uint32_t)std::min(sn, dn - ia), -DWT_BETA);
  step(ib, ia, (uint32_t)dn, (uint32_t)std::min(dn, sn - ib), -DWT_ALPHA);
  for (int32_t k = 0; k < n; k++)
    std::memcpy(a + (size_t)k * w, wv + (size_t)k * rw, sizeof(float) * rw);
}

template <typename T, typename F, typename V>
void idwt2d(TileComp& tc, T* data, F f1d, V vert) {
  if (tc.numres <= 1) return;
  size_t w = (size_t)(tc.x1 - tc.x0);
  std::vector<T> tmp;
  for (uint32_t r = 1; r < tc.numres; r++) {
    const Res& lo = tc.res[r - 1];
    const Res& re = tc.res[r];
    int32_t rw = re.x1 - re.x0, rh = re.y1 - re.y0;
    int32_t hsn = lo.x1 - lo.x0, vsn = lo.y1 - lo.y0;
    int hcas = re.x0 % 2, vcas = re.y0 % 2;
    for (int32_t j = 0; j < rh; j++)
      f1d(data + (size_t)j * w, hsn, rw - hsn, hcas, tmp);
    vert(data, w, rw, vsn, rh - vsn, vcas, tmp);
  }
}

// ------------------------------------------------------------- the decoder

enum Prog { LRCP = 0, RLCP = 1, RPCL = 2, PCRL = 3, CPRL = 4 };

struct Decoder {
  const uint8_t* buf;
  size_t len;
  size_t pos = 0;
  uint32_t ihdr_w = 0, ihdr_h = 0;
  // image
  uint32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  uint32_t tx0 = 0, ty0 = 0, tdx = 0, tdy = 0, tw = 0, th = 0;
  uint32_t rsiz = 0;
  std::vector<Comp> comps;
  TCP def;
  std::vector<TCP> tcps;
  // PPM
  bool ppm = false;
  std::vector<std::vector<uint8_t>> ppm_markers;
  std::vector<bool> ppm_have;
  std::vector<uint8_t> ppm_data;
  size_t ppm_pos = 0;
  std::vector<uint32_t> order;  // tiles in the order they are decoded
  uint32_t numcomps() const { return (uint32_t)comps.size(); }

  uint32_t rd(const uint8_t*& p, int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) v = (v << 8) | *p++;
    return v;
  }

  // ---------------------------------------------------------- markers
  void read_siz(const uint8_t* p, uint32_t size) {
    if (size < 36) fail("Error with SIZ marker size");
    uint32_t nc = (size - 36) / 3;
    if (nc > 16384 || (size - 36) % 3) fail("Error with SIZ marker size");
    rsiz = rd(p, 2);
    x1 = rd(p, 4);
    y1 = rd(p, 4);
    x0 = rd(p, 4);
    y0 = rd(p, 4);
    tdx = rd(p, 4);
    tdy = rd(p, 4);
    tx0 = rd(p, 4);
    ty0 = rd(p, 4);
    uint32_t csiz = rd(p, 2);
    if (csiz != nc)
      fail("Error with SIZ marker: number of component is illegal");
    if (x0 >= x1 || y0 >= y1)
      fail("Error with SIZ marker: negative or zero image size");
    if (tdx == 0 || tdy == 0) fail("Error with SIZ marker: invalid tile size");
    uint32_t tx1 = tx0 + tdx < tx0 ? 0xffffffffu : tx0 + tdx;
    uint32_t ty1 = ty0 + tdy < ty0 ? 0xffffffffu : ty0 + tdy;
    if (tx0 > x0 || ty0 > y0 || tx1 <= x0 || ty1 <= y0)
      fail("Error with SIZ marker: illegal tile offset");
    if (ihdr_w > 0 && ihdr_h > 0 &&
        (ihdr_w != x1 - x0 || ihdr_h != y1 - y0))
      fail("Error with SIZ marker: IHDR w/h vs. SIZ w/h");
    comps.resize(nc);
    for (uint32_t i = 0; i < nc; i++) {
      uint32_t t = rd(p, 1);
      comps[i].prec = (t & 0x7f) + 1;
      comps[i].sgnd = t >> 7;
      comps[i].dx = rd(p, 1);
      comps[i].dy = rd(p, 1);
      if (comps[i].dx < 1 || comps[i].dy < 1)
        fail("Invalid values for comp: dx, dy");
      if (comps[i].prec > 31) fail("Invalid values for comp: prec");
    }
    tw = ceildiv(x1 - tx0, tdx);
    th = ceildiv(y1 - ty0, tdy);
    if (tw == 0 || th == 0 || tw > 65535 / th)
      fail("Invalid number of tiles");
    def.tccps.assign(nc, TCCP());
    for (uint32_t i = 0; i < nc; i++)
      def.tccps[i].dc_shift =
          comps[i].sgnd ? 0 : (int32_t)(1u << (comps[i].prec - 1));
    // image component geometry (opj_image_comp_header_update)
    uint32_t lx0 = std::max(tx0, x0), ly0 = std::max(ty0, y0);
    uint64_t lx1 = std::min<uint64_t>((uint64_t)tx0 + (uint64_t)tw * tdx, x1);
    uint64_t ly1 = std::min<uint64_t>((uint64_t)ty0 + (uint64_t)th * tdy, y1);
    for (auto& c : comps) {
      uint32_t cx0 = ceildiv(lx0, c.dx), cy0 = ceildiv(ly0, c.dy);
      uint32_t cx1 = ceildiv((uint32_t)lx1, c.dx),
               cy1 = ceildiv((uint32_t)ly1, c.dy);
      c.x0 = cx0;
      c.y0 = cy0;
      c.w = cx1 - cx0;
      c.h = cy1 - cy0;
    }
  }

  void read_spcod(TCP& tcp, uint32_t compno, const uint8_t*& p,
                  uint32_t& size) {
    TCCP& tc = tcp.tccps[compno];
    if (size < 5) fail("Error reading SPCod SPCoc element");
    tc.numres = rd(p, 1) + 1;
    if (tc.numres > MAXRLVLS) fail("Invalid value for numresolutions");
    tc.cblkw = rd(p, 1) + 2;
    tc.cblkh = rd(p, 1) + 2;
    if (tc.cblkw > 10 || tc.cblkh > 10 || tc.cblkw + tc.cblkh > 12)
      fail("Error reading SPCod SPCoc element, Invalid cblkw/cblkh "
           "combination");
    tc.cblksty = rd(p, 1);
    if (tc.cblksty & 0x80)
      fail("Error reading SPCod SPCoc element. Unsupported Mixed HT "
           "code-block style found");
    tc.qmfbid = rd(p, 1);
    if (tc.qmfbid > 1)
      fail("Error reading SPCod SPCoc element, Invalid transformation found");
    size -= 5;
    if (tc.csty & 1) {
      if (size < tc.numres) fail("Error reading SPCod SPCoc element");
      for (uint32_t i = 0; i < tc.numres; i++) {
        uint32_t t = rd(p, 1);
        tc.prcw[i] = t & 0xf;
        tc.prch[i] = t >> 4;
        if (i != 0 && (tc.prcw[i] == 0 || tc.prch[i] == 0))
          fail("Invalid precinct size");
      }
      size -= tc.numres;
    } else {
      for (uint32_t i = 0; i < tc.numres; i++) tc.prcw[i] = tc.prch[i] = 15;
    }
  }

  void read_cod(TCP& tcp, const uint8_t* p, uint32_t size) {
    if (size < 5) fail("Error reading COD marker");
    tcp.csty = rd(p, 1);
    if (tcp.csty & ~7u) fail("Unknown Scod value in COD marker");
    tcp.prg = rd(p, 1);
    if (tcp.prg > CPRL) tcp.prg = 0xffffffffu;  // OPJ_PROG_UNKNOWN
    tcp.numlayers = rd(p, 2);
    if (tcp.numlayers < 1) fail("Invalid number of layers in COD marker");
    tcp.mct = rd(p, 1);
    if (tcp.mct > 1) fail("Invalid multiple component transformation");
    size -= 5;
    for (auto& tc : tcp.tccps) tc.csty = tcp.csty & 1;
    read_spcod(tcp, 0, p, size);
    if (size != 0) fail("Error reading COD marker");
    for (uint32_t i = 1; i < numcomps(); i++) {
      TCCP& d = tcp.tccps[i];
      const TCCP& s = tcp.tccps[0];
      d.numres = s.numres;
      d.cblkw = s.cblkw;
      d.cblkh = s.cblkh;
      d.cblksty = s.cblksty;
      d.qmfbid = s.qmfbid;
      std::memcpy(d.prcw, s.prcw, sizeof d.prcw);
      std::memcpy(d.prch, s.prch, sizeof d.prch);
    }
  }

  void read_coc(TCP& tcp, const uint8_t* p, uint32_t size) {
    uint32_t room = numcomps() <= 256 ? 1 : 2;
    if (size < room + 1) fail("Error reading COC marker");
    size -= room + 1;
    uint32_t c = rd(p, room);
    if (c >= numcomps()) fail("Error reading COC marker (bad number of "
                              "components)");
    tcp.tccps[c].csty = rd(p, 1);
    read_spcod(tcp, c, p, size);
    if (size != 0) fail("Error reading COC marker");
  }

  void read_sqcd(TCP& tcp, uint32_t c, const uint8_t*& p, uint32_t& size) {
    TCCP& tc = tcp.tccps[c];
    if (size < 1) fail("Error reading SQcd or SQcc element");
    size -= 1;
    uint32_t t = rd(p, 1);
    tc.qntsty = t & 0x1f;
    tc.numgbits = t >> 5;
    uint32_t nb;
    if (tc.qntsty == 1)
      nb = 1;
    else
      nb = tc.qntsty == 0 ? size : size / 2;
    if (tc.qntsty == 0) {
      if (size < nb) fail("Error reading SQcd or SQcc element");
      for (uint32_t b = 0; b < nb; b++) {
        uint32_t v = rd(p, 1);
        if (b < MAXBANDS) tc.steps[b].expn = (int)(v >> 3), tc.steps[b].mant = 0;
      }
      size -= nb;
    } else {
      if (size < 2 * nb) fail("Error reading SQcd or SQcc element");
      for (uint32_t b = 0; b < nb; b++) {
        uint32_t v = rd(p, 2);
        if (b < MAXBANDS)
          tc.steps[b].expn = (int)(v >> 11), tc.steps[b].mant = (int)(v & 0x7ff);
      }
      size -= 2 * nb;
    }
    if (tc.qntsty == 1) {
      for (int b = 1; b < MAXBANDS; b++) {
        int e = tc.steps[0].expn - (b - 1) / 3;
        tc.steps[b].expn = e > 0 ? e : 0;
        tc.steps[b].mant = tc.steps[0].mant;
      }
    }
  }

  void read_qcd(TCP& tcp, const uint8_t* p, uint32_t size) {
    read_sqcd(tcp, 0, p, size);
    if (size != 0) fail("Error reading QCD marker");
    for (uint32_t i = 1; i < numcomps(); i++) {
      TCCP& d = tcp.tccps[i];
      const TCCP& s = tcp.tccps[0];
      d.qntsty = s.qntsty;
      d.numgbits = s.numgbits;
      std::memcpy(d.steps, s.steps, sizeof d.steps);
    }
  }

  void read_qcc(TCP& tcp, const uint8_t* p, uint32_t size) {
    uint32_t room = numcomps() <= 256 ? 1 : 2;
    if (size < room) fail("Error reading QCC marker");
    uint32_t c = rd(p, room);
    size -= room;
    if (c >= numcomps()) fail("Invalid component number in QCC marker");
    read_sqcd(tcp, c, p, size);
    if (size != 0) fail("Error reading QCC marker");
  }

  void read_rgn(TCP& tcp, const uint8_t* p, uint32_t size) {
    uint32_t room = numcomps() <= 256 ? 1 : 2;
    if (size != 2 + room) fail("Error reading RGN marker");
    uint32_t c = rd(p, room);
    rd(p, 1);  // Srgn
    if (c >= numcomps()) fail("bad component number in RGN");
    tcp.tccps[c].roishift = rd(p, 1);
  }

  void read_poc(TCP& tcp, const uint8_t* p, uint32_t size) {
    uint32_t room = numcomps() <= 256 ? 1 : 2;
    uint32_t chunk = 5 + 2 * room;
    uint32_t n = size / chunk;
    if (n == 0 || size % chunk) fail("Error reading POC marker");
    for (uint32_t i = 0; i < n; i++) {
      Poc q;
      q.resno0 = rd(p, 1);
      q.compno0 = rd(p, room);
      q.layno1 = std::min(rd(p, 2), tcp.numlayers);
      q.resno1 = rd(p, 1);
      q.compno1 = std::min(rd(p, room), numcomps());
      q.prg = rd(p, 1);
      tcp.pocs.push_back(q);
    }
  }

  void read_ppm(const uint8_t* p, uint32_t size) {
    if (size < 2) fail("Error reading PPM marker");
    ppm = true;
    uint32_t z = rd(p, 1);
    if (ppm_markers.size() <= z) {
      ppm_markers.resize(z + 1);
      ppm_have.resize(z + 1, false);
    }
    if (ppm_have[z]) fail("Zppm already read");
    ppm_have[z] = true;
    ppm_markers[z].assign(p, p + size - 1);
  }

  void merge_ppm() {
    if (!ppm) return;
    uint32_t remaining = 0;
    for (size_t i = 0; i < ppm_markers.size(); i++) {
      if (!ppm_have[i]) continue;
      const std::vector<uint8_t>& m = ppm_markers[i];
      size_t at = 0, n = m.size();
      if (remaining >= n) {
        ppm_data.insert(ppm_data.end(), m.begin(), m.end());
        remaining -= (uint32_t)n;
        continue;
      }
      ppm_data.insert(ppm_data.end(), m.begin(), m.begin() + remaining);
      at = remaining;
      remaining = 0;
      while (at < n) {
        if (n - at < 4) fail("Not enough bytes to read Nppm");
        const uint8_t* q = &m[at];
        uint32_t nppm = rd(q, 4);
        at += 4;
        if (n - at >= nppm) {
          ppm_data.insert(ppm_data.end(), m.begin() + at, m.begin() + at + nppm);
          at += nppm;
        } else {
          ppm_data.insert(ppm_data.end(), m.begin() + at, m.end());
          remaining = nppm - (uint32_t)(n - at);
          at = n;
        }
      }
    }
    if (remaining) fail("Corrupted PPM markers");
  }

  void read_ppt(TCP& tcp, const uint8_t* p, uint32_t size) {
    if (size < 2) fail("Error reading PPT marker");
    if (ppm)
      fail("Error reading PPT marker: packet header have been previously "
           "found in the main header (PPM marker).");
    tcp.ppt = true;
    uint32_t z = rd(p, 1);
    if (tcp.ppt_markers.size() <= z) {
      tcp.ppt_markers.resize(z + 1);
      tcp.ppt_have.resize(z + 1, false);
    }
    if (tcp.ppt_have[z]) fail("Zppt already read");
    tcp.ppt_have[z] = true;
    tcp.ppt_markers[z].assign(p, p + size - 1);
  }

  // OpenJPEG 2.5 reads TLM and PLM leniently: only their sizes
  void read_tlm(uint32_t size) {
    if (size < 2) fail("Error reading TLM marker");
  }

  void read_plm(uint32_t size) {
    if (size < 1) fail("Error reading PLM marker");
  }

  void read_plt(const uint8_t* p, uint32_t size) {
    if (size < 1) fail("Error reading PLT marker");
    rd(p, 1);
    --size;
    uint32_t packet_len = 0;
    for (uint32_t i = 0; i < size; i++) {
      uint32_t t = rd(p, 1);
      packet_len |= t & 0x7f;
      if (t & 0x80)
        packet_len <<= 7;
      else
        packet_len = 0;
    }
    if (packet_len != 0) fail("Error reading PLT marker");
  }

  // ---------------------------------------------------------- stream
  bool read2(uint32_t& v) {
    if (len - pos < 2) {
      pos = len;
      return false;
    }
    v = (uint32_t)buf[pos] << 8 | buf[pos + 1];
    pos += 2;
    return true;
  }

  enum State { MHSIZ = 1, MH = 2, TPHSOT = 4, TPH = 8 };

  // OpenJPEG's marker handler table: the states a marker may appear in,
  // -1 for a marker it does not list (SOD, EOC and EPH among them: its
  // loops test those by value); SOP is listed with no state
  static int marker_states(uint32_t m) {
    switch (m) {
      case 0xff51: return MHSIZ;                  // SIZ
      case 0xff52: case 0xff53: case 0xff5c: case 0xff5d:  // COD COC QCD QCC
      case 0xff5e: case 0xff5f: case 0xff64:      // RGN POC COM
      case 0xff74: case 0xff75: case 0xff77:      // MCT MCC MCO
        return MH | TPH;
      case 0xff60: case 0xff55: case 0xff57: case 0xff63:  // PPM TLM PLM CRG
      case 0xff50: case 0xff59: case 0xff78:      // CAP CPF CBD
        return MH;
      case 0xff61: case 0xff58: return TPH;      // PPT PLT
      case 0xff90: return MH | TPHSOT;           // SOT
      case 0xff91: return 0;                     // SOP
      default: return -1;                        // unknown
    }
  }
  static const int UNK_STATES = MH | TPH;

  // OpenJPEG's opj_j2k_read_unk: scan 2 bytes at a time for a listed
  // marker
  uint32_t skip_unknown(int state) {
    for (;;) {
      uint32_t m;
      if (!read2(m)) fail("Stream too short");
      if (m >= 0xff00) {
        int st = marker_states(m);
        if (!((st < 0 ? UNK_STATES : st) & state))
          fail("Marker is not compliant with its position");
        if (st >= 0) return m;
      }
    }
  }

  void handle(uint32_t m, TCP& tcp, const uint8_t* p, uint32_t size) {
    switch (m) {
      case 0xff51: read_siz(p, size); break;
      case 0xff52: read_cod(tcp, p, size); break;
      case 0xff53: read_coc(tcp, p, size); break;
      case 0xff5c: read_qcd(tcp, p, size); break;
      case 0xff5d: read_qcc(tcp, p, size); break;
      case 0xff5e: read_rgn(tcp, p, size); break;
      case 0xff5f: read_poc(tcp, p, size); break;
      case 0xff60: read_ppm(p, size); break;
      case 0xff61: read_ppt(tcp, p, size); break;
      case 0xff55: read_tlm(size); break;
      case 0xff57: read_plm(size); break;
      case 0xff58: read_plt(p, size); break;
      case 0xff63:
        if (size != numcomps() * 4) fail("Error reading CRG marker");
        break;
      case 0xff64: break;  // COM
      case 0xff50:
        throw NotYet{"HTJ2K (the CAP marker)"};
      case 0xff59: break;  // CPF
      case 0xff74: case 0xff75: case 0xff77: case 0xff78:
        throw NotYet{"JPEG 2000 Part 2 (MCT/MCC/MCO/CBD markers)"};
      default: break;
    }
  }

  void read_main_header() {
    uint32_t m;
    if (!read2(m) || m != 0xff4f) fail("Expected a SOC marker");
    int state = MHSIZ;
    if (!read2(m)) fail("Stream too short");
    bool has_siz = false, has_cod = false, has_qcd = false;
    while (m != 0xff90) {
      if (m < 0xff00) fail("A marker ID was expected (0xff--)");
      int st = marker_states(m);
      if (st < 0) {
        m = skip_unknown(state);
        if (m == 0xff90) break;
        st = marker_states(m);
      }
      if (m == 0xff51) has_siz = true;
      if (m == 0xff52) has_cod = true;
      if (m == 0xff5c) has_qcd = true;
      if (!(st & state)) fail("Marker is not compliant with its position");
      uint32_t size;
      if (!read2(size)) fail("Stream too short");
      if (size < 2) fail("Invalid marker size");
      size -= 2;
      if (len - pos < size) fail("Stream too short");
      handle(m, def, buf + pos, size);
      pos += size;
      if (m == 0xff51) state = MH;
      if (!read2(m)) fail("Stream too short");
    }
    if (!has_siz) fail("required SIZ marker not found in main header");
    if (!has_cod) fail("required COD marker not found in main header");
    if (!has_qcd) fail("required QCD marker not found in main header");
    merge_ppm();
    for (uint32_t c = 0; c < numcomps(); c++)
      if (def.tccps[c].cblksty & CBLKSTY_HT)
        throw NotYet{"HTJ2K (code-block style 0x40)"};
    if (rsiz & 0x8000) throw NotYet{"JPEG 2000 Part 2 (Rsiz bit 15)"};
    tcps.assign((size_t)tw * th, def);
  }

  // reads tile-parts until EOC; returns with `order` filled.  As
  // OpenJPEG: a tile whose last tile-part (TNsot) is read is decoded at
  // once and must be followed by 2 more bytes; once every tile is
  // decoded, reading stops; a stream that ends right after a marker code
  // ends the codestream (the first tile at or after the current one
  // with data is decoded); at EOC every tile with data is decoded.
  void read_tiles() {
    // the SOT marker code was read by read_main_header
    uint32_t m = 0xff90;
    uint32_t cur = 0, ndecoded = 0;
    int state = TPHSOT;
    bool can_decode = false, last_part = false;
    int64_t sot_left = 0;
    auto neoc = [&]() {
      for (uint32_t t = cur; t < tw * th; t++)
        if (tcps[t].has_data && !tcps[t].decoded) {
          order.push_back(t);
          tcps[t].decoded = true;
          break;
        }
    };
    for (;;) {
      if (m == 0xffd9) {  // EOC: every tile with data is decoded
        for (uint32_t t = 0; t < tw * th; t++)
          if (tcps[t].has_data && !tcps[t].decoded) {
            order.push_back(t);
            tcps[t].decoded = true;
          }
        break;
      }
      // a tile-part header: markers up to SOD (opj_j2k_read_tile_header)
      bool ended = false;
      while (m != 0xff93) {
        if (pos == len) {
          // only at a tile-part's SOT code: once its header has begun,
          // a stream that ends is refused (strict mode)
          if (state != TPHSOT) fail("Stream too short");
          ended = true;
          break;
        }
        uint32_t msize;
        if (!read2(msize)) fail("Stream too short");
        if (msize < 2) fail("Inconsistent marker size");
        if (m == 0x8080 && pos == len) {
          ended = true;
          break;
        }
        if ((state & TPH) && !last_part && sot_left != 0) {
          if (sot_left < (int64_t)msize + 2)
            fail("Sot length is not coherent with the current marker size");
          sot_left -= msize + 2;
        }
        msize -= 2;
        int st = marker_states(m);
        if (!((st < 0 ? UNK_STATES : st) & state))
          fail("Marker is not compliant with its position");
        if (len - pos < msize) fail("Stream too short");
        if (st <= 0) fail("Not sure how that happened.");  // no handler
        if (m == 0xff90) {
          if (msize != 8) fail("Error reading SOT marker");
          const uint8_t* p = buf + pos;
          uint32_t isot = rd(p, 2), psot = rd(p, 4), tpsot = rd(p, 1),
                   tnsot = rd(p, 1);
          if (isot >= tw * th) fail("Invalid tile number");
          cur = isot;
          TCP& tcp = tcps[isot];
          if (tcp.cur_part + 1 != (int32_t)tpsot)
            fail("Invalid tile part index");
          tcp.cur_part = (int32_t)tpsot;
          if (psot != 0 && psot < 14 && psot != 12)
            fail("Psot value is not correct");
          last_part = psot == 0;
          if (tcp.nb_parts != 0 && tpsot >= tcp.nb_parts)
            fail("In SOT marker, TPSot is not valid");
          if (tnsot != 0) {
            if (tpsot >= tnsot) fail("In SOT marker, TPSot is not valid");
            tcp.nb_parts = tnsot;
          }
          can_decode = tcp.nb_parts && tcp.nb_parts == tpsot + 1;
          sot_left = last_part ? 0 : (int64_t)psot - 12;
          state = TPH;
        } else {
          handle(m, tcps[cur], buf + pos, msize);
        }
        pos += msize;
        if (!read2(m)) fail("Stream too short");
      }
      if (ended) {
        neoc();
        break;
      }
      // SOD: the tile-part's data
      TCP& tcp = tcps[cur];
      size_t n;
      if (last_part) {
        if (len - pos < 2) fail("Stream too short");
        n = len - pos - 2;
      } else {
        n = sot_left >= 2 ? (size_t)(sot_left - 2) : 0;
        if (len - pos < n)
          fail("Tile part length size inconsistent with stream length");
      }
      tcp.data.insert(tcp.data.end(), buf + pos, buf + pos + n);
      tcp.has_data = true;
      pos += n;
      state = TPHSOT;
      for (uint32_t c = 0; c < numcomps(); c++)
        if (tcp.tccps[c].cblksty & CBLKSTY_HT)
          throw NotYet{"HTJ2K (code-block style 0x40)"};
      if (can_decode) {
        can_decode = false;
        order.push_back(cur);
        tcp.decoded = true;
        ndecoded++;
        // OpenJPEG decodes the tile, then wants a marker
        if (len - pos < 2) fail("Stream too short");
        read2(m);
        if (m == 0xffd9) continue;  // the EOC branch decodes the rest
        if (m != 0xff90) {
          if (len - pos == 0) break;  // "Stream does not end with EOC"
          fail("Stream too short, expected SOT");
        }
        if (ndecoded == tw * th) break;
        continue;
      }
      if (!read2(m)) {
        // OpenJPEG's allowance for a missing EOC after the last tile
        bool ok = false;
        uint32_t first = 0;
        if (cur + 1 == tw * th)
          for (; first < tw * th && !ok; first++)
            ok = tcps[first].cur_part == 0 && tcps[first].nb_parts == 0;
        if (!ok) fail("Stream too short");
        for (uint32_t t = first - 1; t < tw * th; t++)
          if (tcps[t].has_data && !tcps[t].decoded) {
            order.push_back(t);
            tcps[t].decoded = true;
          }
        break;
      }
    }
    if (order.empty()) fail("no tile decoded");
  }

  // ---------------------------------------------------------- tile layout
  void init_tile(uint32_t tileno, std::vector<TileComp>& tiles) {
    TCP& tcp = tcps[tileno];
    uint32_t p = tileno % tw, q = tileno / tw;
    uint32_t ttx0 = std::max<uint32_t>(tx0 + p * tdx, x0);
    uint32_t tty0 = std::max<uint32_t>(ty0 + q * tdy, y0);
    uint32_t ttx1 = (uint32_t)std::min<uint64_t>((uint64_t)tx0 + (uint64_t)(p + 1) * tdx, x1);
    uint32_t tty1 = (uint32_t)std::min<uint64_t>((uint64_t)ty0 + (uint64_t)(q + 1) * tdy, y1);
    tiles.assign(numcomps(), TileComp());
    for (uint32_t c = 0; c < numcomps(); c++) {
      TileComp& tc = tiles[c];
      const TCCP& cp = tcp.tccps[c];
      const Comp& ic = comps[c];
      tc.x0 = (int32_t)ceildiv(ttx0, ic.dx);
      tc.y0 = (int32_t)ceildiv(tty0, ic.dy);
      tc.x1 = (int32_t)ceildiv(ttx1, ic.dx);
      tc.y1 = (int32_t)ceildiv(tty1, ic.dy);
      tc.numres = cp.numres;
      tc.res.assign(cp.numres, Res());
      size_t area = (size_t)(tc.x1 - tc.x0) * (size_t)(tc.y1 - tc.y0);
      if (cp.qmfbid == 1)
        tc.idata.assign(area, 0);
      else
        tc.fdata.assign(area, 0.0f);
      for (uint32_t r = 0; r < cp.numres; r++) {
        Res& re = tc.res[r];
        int32_t level = (int32_t)(cp.numres - 1 - r);
        re.x0 = int_ceildivpow2(tc.x0, level);
        re.y0 = int_ceildivpow2(tc.y0, level);
        re.x1 = int_ceildivpow2(tc.x1, level);
        re.y1 = int_ceildivpow2(tc.y1, level);
        uint32_t pdx = cp.prcw[r], pdy = cp.prch[r];
        re.pdx = pdx;
        re.pdy = pdy;
        int32_t tlpx = int_floordivpow2(re.x0, (int32_t)pdx) << pdx;
        int32_t tlpy = int_floordivpow2(re.y0, (int32_t)pdy) << pdy;
        int32_t brpx = (int32_t)((uint32_t)int_ceildivpow2(re.x1, (int32_t)pdx) << pdx);
        int32_t brpy = (int32_t)((uint32_t)int_ceildivpow2(re.y1, (int32_t)pdy) << pdy);
        re.pw = re.x0 == re.x1 ? 0 : (uint32_t)((brpx - tlpx) >> pdx);
        re.ph = re.y0 == re.y1 ? 0 : (uint32_t)((brpy - tlpy) >> pdy);
        if ((uint64_t)re.pw * re.ph > (1u << 28)) fail("too many precincts");
        int32_t tlcbgx, tlcbgy;
        uint32_t cbgw, cbgh;
        if (r == 0) {
          tlcbgx = tlpx;
          tlcbgy = tlpy;
          cbgw = pdx;
          cbgh = pdy;
          re.numbands = 1;
        } else {
          tlcbgx = int_ceildivpow2(tlpx, 1);
          tlcbgy = int_ceildivpow2(tlpy, 1);
          cbgw = pdx - 1;
          cbgh = pdy - 1;
          re.numbands = 3;
        }
        uint32_t cbw = std::min(cp.cblkw, cbgw), cbh = std::min(cp.cblkh, cbgh);
        for (uint32_t b = 0; b < re.numbands; b++) {
          Band& bd = re.bands[b];
          if (r == 0) {
            bd.bandno = 0;
            bd.x0 = int_ceildivpow2(tc.x0, level);
            bd.y0 = int_ceildivpow2(tc.y0, level);
            bd.x1 = int_ceildivpow2(tc.x1, level);
            bd.y1 = int_ceildivpow2(tc.y1, level);
          } else {
            bd.bandno = b + 1;
            int64_t xob = bd.bandno & 1, yob = bd.bandno >> 1;
            bd.x0 = int64_ceildivpow2((int64_t)tc.x0 - (xob << level), level + 1);
            bd.y0 = int64_ceildivpow2((int64_t)tc.y0 - (yob << level), level + 1);
            bd.x1 = int64_ceildivpow2((int64_t)tc.x1 - (xob << level), level + 1);
            bd.y1 = int64_ceildivpow2((int64_t)tc.y1 - (yob << level), level + 1);
          }
          const StepSize& ss = cp.steps[r == 0 ? 0 : 3 * r - 2 + b];
          int gain = cp.qmfbid == 0 ? 0 : bd.bandno == 0 ? 0 : bd.bandno == 3 ? 2 : 1;
          int rb = (int)ic.prec + gain;
          bd.stepsize = (float)((1.0 + ss.mant / 2048.0) * std::pow(2.0, (int)(rb - ss.expn)));
          bd.numbps = ss.expn + (int32_t)cp.numgbits - 1;
          uint32_t np = re.pw * re.ph;
          bd.precs.assign(np, Precinct());
          for (uint32_t pi = 0; pi < np; pi++) {
            Precinct& pr = bd.precs[pi];
            int32_t cbgx0 = tlcbgx + (int32_t)(pi % re.pw) * (1 << cbgw);
            int32_t cbgy0 = tlcbgy + (int32_t)(pi / re.pw) * (1 << cbgh);
            int32_t cbgx1 = cbgx0 + (1 << cbgw), cbgy1 = cbgy0 + (1 << cbgh);
            pr.x0 = std::max(cbgx0, bd.x0);
            pr.y0 = std::max(cbgy0, bd.y0);
            pr.x1 = std::min(cbgx1, bd.x1);
            pr.y1 = std::min(cbgy1, bd.y1);
            int32_t tlcx = int_floordivpow2(pr.x0, (int32_t)cbw) << cbw;
            int32_t tlcy = int_floordivpow2(pr.y0, (int32_t)cbh) << cbh;
            int32_t brcx = int_ceildivpow2(pr.x1, (int32_t)cbw) << cbw;
            int32_t brcy = int_ceildivpow2(pr.y1, (int32_t)cbh) << cbh;
            int32_t cw = (brcx - tlcx) >> cbw, ch = (brcy - tlcy) >> cbh;
            pr.cw = cw > 0 ? (uint32_t)cw : 0;
            pr.ch = ch > 0 ? (uint32_t)ch : 0;
            if (bd.empty()) pr.cw = pr.ch = 0;
            pr.cblks.resize((size_t)pr.cw * pr.ch);
            for (uint32_t k = 0; k < pr.cw * pr.ch; k++) {
              Cblk& cb = pr.cblks[k];
              int32_t cx0 = tlcx + (int32_t)(k % pr.cw) * (1 << cbw);
              int32_t cy0 = tlcy + (int32_t)(k / pr.cw) * (1 << cbh);
              cb.x0 = std::max(cx0, pr.x0);
              cb.y0 = std::max(cy0, pr.y0);
              cb.x1 = std::min(cx0 + (1 << cbw), pr.x1);
              cb.y1 = std::min(cy0 + (1 << cbh), pr.y1);
            }
            pr.incl.build(pr.cw, pr.ch);
            pr.imsb.build(pr.cw, pr.ch);
          }
        }
      }
    }
  }

  // ---------------------------------------------------------- tier 2
  void init_seg(Cblk& cb, uint32_t index, uint32_t sty, bool first) {
    if (cb.segs.size() <= index) cb.segs.resize(index + 1);
    Seg& s = cb.segs[index];
    s = Seg();
    if (sty & CBLKSTY_TERMALL)
      s.maxpasses = 1;
    else if (sty & CBLKSTY_LAZY) {
      if (first)
        s.maxpasses = 10;
      else {
        uint32_t pm = cb.segs[index - 1].maxpasses;
        s.maxpasses = (pm == 1 || pm == 10) ? 2 : 1;
      }
    } else
      s.maxpasses = 109;
  }

  static uint32_t floorlog2(uint32_t a) {
    uint32_t l = 0;
    while (a > 1) a >>= 1, l++;
    return l;
  }

  // decodes one packet; `src`/`left` is the tile's remaining data
  void decode_packet(TCP& tcp, std::vector<TileComp>& tiles, uint32_t compno,
                     uint32_t resno, uint32_t precno, uint32_t layno,
                     const uint8_t*& src, size_t& left) {
    TileComp& tc = tiles[compno];
    Res& re = tc.res[resno];
    uint32_t sty = tcp.tccps[compno].cblksty;
    const uint8_t* cur = src;
    const uint8_t* end = src + left;
    if (tcp.csty & 2) {  // SOP (optional)
      if (left >= 6 && cur[0] == 0xff && cur[1] == 0x91) cur += 6;
    }
    const uint8_t* hdr;
    size_t hlen;
    size_t* hpos = nullptr;
    size_t local = 0;
    if (ppm) {
      hdr = ppm_data.data() + ppm_pos;
      hlen = ppm_data.size() - ppm_pos;
      hpos = &ppm_pos;
    } else if (tcp.ppt) {
      hdr = tcp.ppt_data.data() + tcp.ppt_pos;
      hlen = tcp.ppt_data.size() - tcp.ppt_pos;
      hpos = &tcp.ppt_pos;
    } else {
      hdr = cur;
      hlen = (size_t)(end - cur);
      hpos = &local;
    }
    Bio bio(hdr, hlen);
    bool present = bio.bit();
    if (present) {
      for (uint32_t b = 0; b < re.numbands; b++) {
        Band& bd = re.bands[b];
        if (bd.empty()) continue;
        if (precno >= bd.precs.size()) fail("Invalid precinct");
        Precinct& pr = bd.precs[precno];
        uint32_t ncb = pr.cw * pr.ch;
        for (uint32_t k = 0; k < ncb; k++) {
          Cblk& cb = pr.cblks[k];
          uint32_t included;
          if (!cb.numsegs)
            included = pr.incl.decode(bio, k, (int32_t)(layno + 1));
          else
            included = bio.bit();
          if (!included) {
            cb.numnewpasses = 0;
            continue;
          }
          if (!cb.numsegs) {
            uint32_t i = 0;
            while (!pr.imsb.decode(bio, k, (int32_t)i)) ++i;
            cb.numbps = (uint32_t)bd.numbps + 1 - i;
            cb.numlenbits = 3;
          }
          // number of passes
          uint32_t np;
          if (!bio.bit())
            np = 1;
          else if (!bio.bit())
            np = 2;
          else {
            uint32_t n = bio.read(2);
            if (n != 3)
              np = 3 + n;
            else if ((n = bio.read(5)) != 31)
              np = 6 + n;
            else
              np = 37 + bio.read(7);
          }
          cb.numnewpasses = np;
          uint32_t inc = 0;
          while (bio.bit()) inc++;
          cb.numlenbits += inc;
          uint32_t segno;
          if (!cb.numsegs) {
            segno = 0;
            init_seg(cb, 0, sty, true);
          } else {
            segno = cb.numsegs - 1;
            if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
              ++segno;
              init_seg(cb, segno, sty, false);
            }
          }
          int32_t n = (int32_t)np;
          do {
            Seg& s = cb.segs[segno];
            s.numnewpasses = (uint32_t)std::min<int64_t>(
                (int64_t)s.maxpasses - s.numpasses, n);
            uint32_t bits = cb.numlenbits + floorlog2(s.numnewpasses);
            if (bits > 32) fail("Invalid bit number in packet header");
            s.newlen = bio.read((int)bits);
            n -= (int32_t)s.numnewpasses;
            if (n > 0) {
              ++segno;
              init_seg(cb, segno, sty, false);
            }
          } while (n > 0);
        }
      }
    }
    bio.inalign();
    const uint8_t* h = hdr + bio.numbytes();
    if (tcp.csty & 4) {  // EPH: required where Scod announces it
      size_t used = (size_t)(h - hdr);
      if (hlen - used < 2) fail("Not enough space for expected EPH marker");
      if (h[0] != 0xff || h[1] != 0x92) fail("Expected EPH marker");
      h += 2;
    }
    size_t hl = (size_t)(h - hdr);
    if (ppm || tcp.ppt) {
      *hpos += hl;
    } else {
      cur = h;
    }
    if (present) {
      for (uint32_t b = 0; b < re.numbands; b++) {
        Band& bd = re.bands[b];
        if (bd.empty()) continue;
        Precinct& pr = bd.precs[precno];
        for (uint32_t k = 0; k < pr.cw * pr.ch; k++) {
          Cblk& cb = pr.cblks[k];
          if (!cb.numnewpasses) continue;
          uint32_t si;
          if (!cb.numsegs) {
            si = 0;
            ++cb.numsegs;
          } else {
            si = cb.numsegs - 1;
            if (cb.segs[si].numpasses == cb.segs[si].maxpasses) {
              ++si;
              ++cb.numsegs;
            }
          }
          do {
            Seg& s = cb.segs[si];
            if ((size_t)(end - cur) < s.newlen)
              fail("read: segment too long");
            cb.data.insert(cb.data.end(), cur, cur + s.newlen);
            cur += s.newlen;
            s.numpasses += s.numnewpasses;
            cb.numnewpasses -= s.numnewpasses;
            s.len += s.newlen;
            if (cb.numnewpasses > 0) {
              ++si;
              ++cb.numsegs;
            }
          } while (cb.numnewpasses > 0);
        }
      }
    }
    left -= (size_t)(cur - src);
    src = cur;
  }

  struct Pi {
    uint32_t compno, resno, precno, layno;
  };

  // the packets of a tile, in the order of its progressions
  void packets(TCP& tcp, std::vector<TileComp>& tiles, uint32_t tileno,
               std::vector<Pi>& out) {
    uint32_t nc = numcomps();
    uint32_t maxres = 0, maxprec = 0;
    for (uint32_t c = 0; c < nc; c++) {
      maxres = std::max(maxres, tiles[c].numres);
      for (uint32_t r = 0; r < tiles[c].numres; r++)
        maxprec = std::max(maxprec, tiles[c].res[r].pw * tiles[c].res[r].ph);
    }
    size_t step_p = 1, step_c = maxprec, step_r = (size_t)nc * step_c,
           step_l = (size_t)maxres * step_r;
    size_t include_size = (size_t)tcp.numlayers * step_l;
    std::vector<uint8_t> include(include_size, 0);
    std::vector<Poc> pocs;
    bool poc = !tcp.pocs.empty();
    if (poc) {
      pocs = tcp.pocs;
    } else {
      pocs.push_back(Poc{0, 0, tcp.numlayers, maxres, nc, tcp.prg});
    }
    uint32_t p = tileno % tw, q = tileno / tw;
    uint32_t ttx0 = std::max<uint32_t>(tx0 + p * tdx, x0);
    uint32_t tty0 = std::max<uint32_t>(ty0 + q * tdy, y0);
    uint32_t ttx1 = (uint32_t)std::min<uint64_t>((uint64_t)tx0 + (uint64_t)(p + 1) * tdx, x1);
    uint32_t tty1 = (uint32_t)std::min<uint64_t>((uint64_t)ty0 + (uint64_t)(q + 1) * tdy, y1);
    auto emit = [&](uint32_t l, uint32_t r, uint32_t c, uint32_t pr) {
      size_t index = l * step_l + r * step_r + c * step_c + pr * step_p;
      if (index >= include_size) fail("Invalid access to pi->include");
      if (!include[index]) {
        include[index] = 1;
        out.push_back(Pi{c, r, pr, l});
      }
    };
    for (const Poc& pc : pocs) {
      uint32_t layno1 = poc ? std::min(pc.layno1, tcp.numlayers) : pc.layno1;
      uint32_t resno0 = pc.resno0, resno1 = pc.resno1;
      uint32_t compno0 = pc.compno0, compno1 = pc.compno1;
      if (pc.prg == 0xffffffffu) fail("unknown progression order");
      if (compno0 >= nc || compno1 >= nc + 1)
        fail("invalid compno0/compno1");
      auto prec_count = [&](uint32_t c, uint32_t r) {
        const Res& re = tiles[c].res[r];
        return re.pw * re.ph;
      };
      if (pc.prg == LRCP) {
        for (uint32_t l = 0; l < layno1; l++)
          for (uint32_t r = resno0; r < resno1; r++)
            for (uint32_t c = compno0; c < compno1; c++) {
              if (r >= tiles[c].numres) continue;
              for (uint32_t pr = 0; pr < prec_count(c, r); pr++) emit(l, r, c, pr);
            }
      } else if (pc.prg == RLCP) {
        for (uint32_t r = resno0; r < resno1; r++)
          for (uint32_t l = 0; l < layno1; l++)
            for (uint32_t c = compno0; c < compno1; c++) {
              if (r >= tiles[c].numres) continue;
              for (uint32_t pr = 0; pr < prec_count(c, r); pr++) emit(l, r, c, pr);
            }
      } else if (pc.prg <= CPRL) {
        // position-driven orders (OpenJPEG's pi.c)
        auto min_d = [&](uint32_t c0, uint32_t c1, uint32_t& dx, uint32_t& dy) {
          dx = dy = 0;
          for (uint32_t c = c0; c < c1; c++) {
            const Comp& ic = comps[c];
            for (uint32_t r = 0; r < tiles[c].numres; r++) {
              const Res& re = tiles[c].res[r];
              uint32_t sh = re.pdx + tiles[c].numres - 1 - r;
              if (sh < 32 && ic.dx <= 0xffffffffu / (1u << sh)) {
                uint32_t d = ic.dx * (1u << sh);
                dx = !dx ? d : std::min(dx, d);
              }
              sh = re.pdy + tiles[c].numres - 1 - r;
              if (sh < 32 && ic.dy <= 0xffffffffu / (1u << sh)) {
                uint32_t d = ic.dy * (1u << sh);
                dy = !dy ? d : std::min(dy, d);
              }
            }
          }
        };
        auto visit = [&](uint32_t c, uint32_t r, uint32_t y, uint32_t x,
                         uint32_t l0, uint32_t l1) {
          const Comp& ic = comps[c];
          if (r >= tiles[c].numres) return;
          const Res& re = tiles[c].res[r];
          uint32_t levelno = tiles[c].numres - 1 - r;
          if (levelno >= 32)
            throw NotYet{"32 decomposition levels under a position-driven "
                         "progression"};
          if (((ic.dx << levelno) >> levelno) != ic.dx ||
              ((ic.dy << levelno) >> levelno) != ic.dy)
            return;
          uint32_t trx0 = ceildiv(ttx0, ic.dx << levelno);
          uint32_t try0 = ceildiv(tty0, ic.dy << levelno);
          uint32_t trx1 = ceildiv(ttx1, ic.dx << levelno);
          uint32_t try1 = ceildiv(tty1, ic.dy << levelno);
          // 64-bit: OpenJPEG 2.5 tests these positions past 2^31 too
          uint32_t rpx = re.pdx + levelno, rpy = re.pdy + levelno;
          if (!(((uint64_t)y % ((uint64_t)ic.dy << rpy) == 0) ||
                ((y == tty0) && (((uint64_t)try0 << levelno) % ((uint64_t)1 << rpy)))))
            return;
          if (!(((uint64_t)x % ((uint64_t)ic.dx << rpx) == 0) ||
                ((x == ttx0) && (((uint64_t)trx0 << levelno) % ((uint64_t)1 << rpx)))))
            return;
          if (re.pw == 0 || re.ph == 0) return;
          if (trx0 == trx1 || try0 == try1) return;
          uint32_t prci = (ceildiv(x, ic.dx << levelno) >> re.pdx) - (trx0 >> re.pdx);
          uint32_t prcj = (ceildiv(y, ic.dy << levelno) >> re.pdy) - (try0 >> re.pdy);
          uint32_t precno = prci + prcj * re.pw;
          for (uint32_t l = l0; l < l1; l++) emit(l, r, c, precno);
        };
        if (pc.prg == RPCL) {
          uint32_t dx, dy;
          min_d(0, nc, dx, dy);
          if (dx == 0 || dy == 0) continue;
          for (uint32_t r = resno0; r < resno1; r++)
            for (uint32_t y = tty0; y < tty1; y += dy - (y % dy))
              for (uint32_t x = ttx0; x < ttx1; x += dx - (x % dx))
                for (uint32_t c = compno0; c < compno1; c++)
                  visit(c, r, y, x, 0, layno1);
        } else if (pc.prg == PCRL) {
          uint32_t dx, dy;
          min_d(0, nc, dx, dy);
          if (dx == 0 || dy == 0) continue;
          for (uint32_t y = tty0; y < tty1; y += dy - (y % dy))
            for (uint32_t x = ttx0; x < ttx1; x += dx - (x % dx))
              for (uint32_t c = compno0; c < compno1; c++)
                for (uint32_t r = resno0; r < std::min(resno1, tiles[c].numres); r++)
                  visit(c, r, y, x, 0, layno1);
        } else {
          for (uint32_t c = compno0; c < compno1; c++) {
            uint32_t dx, dy;
            min_d(c, c + 1, dx, dy);
            if (dx == 0 || dy == 0) continue;
            for (uint32_t y = tty0; y < tty1; y += dy - (y % dy))
              for (uint32_t x = ttx0; x < ttx1; x += dx - (x % dx))
                for (uint32_t r = resno0; r < std::min(resno1, tiles[c].numres); r++)
                  visit(c, r, y, x, 0, layno1);
          }
        }
      }
    }
  }

  void merge_ppt(TCP& tcp) {
    if (!tcp.ppt) return;
    tcp.ppt_data.clear();
    for (size_t i = 0; i < tcp.ppt_markers.size(); i++)
      if (tcp.ppt_have[i])
        tcp.ppt_data.insert(tcp.ppt_data.end(), tcp.ppt_markers[i].begin(),
                            tcp.ppt_markers[i].end());
    tcp.ppt_pos = 0;
  }

  // ---------------------------------------------------------- a tile
  void decode_tile(uint32_t tileno) {
    TCP& tcp = tcps[tileno];
    merge_ppt(tcp);
    std::vector<TileComp> tiles;
    init_tile(tileno, tiles);
    std::vector<Pi> pis;
    packets(tcp, tiles, tileno, pis);
    const uint8_t* src = tcp.data.data();
    size_t left = tcp.data.size();
    for (const Pi& pi : pis) {
      decode_packet(tcp, tiles, pi.compno, pi.resno, pi.precno, pi.layno, src,
                    left);
      Comp& ic = comps[pi.compno];
      ic.resno_decoded = std::max(ic.resno_decoded, pi.resno);
    }
    // OpenJPEG stops the inverse DWT at the highest resolution that had
    // a packet (in any tile so far); only POCs that skip a component's
    // top resolution do that
    for (uint32_t c = 0; c < numcomps(); c++)
      if (comps[c].resno_decoded + 1 < tiles[c].numres)
        throw NotYet{"a POC that gives a component's top resolution no "
                     "packet"};
    // tier 1 and dequantisation
    T1 t1;
    for (uint32_t c = 0; c < numcomps(); c++) {
      TileComp& tc = tiles[c];
      const TCCP& cp = tcp.tccps[c];
      size_t tw_ = (size_t)(tc.x1 - tc.x0);
      for (uint32_t r = 0; r < tc.numres; r++) {
        Res& re = tc.res[r];
        for (uint32_t b = 0; b < re.numbands; b++) {
          Band& bd = re.bands[b];
          if (bd.empty()) continue;
          for (Precinct& pr : bd.precs)
            for (Cblk& cb : pr.cblks) {
              if (cb.x1 <= cb.x0 || cb.y1 <= cb.y0) continue;
              if (!decode_cblk(t1, cb, bd.bandno, cp.roishift, cp.cblksty))
                fail("opj_t1_decode_cblk(): unsupported bpno_plus_one");
              uint32_t w = (uint32_t)(cb.x1 - cb.x0), h = (uint32_t)(cb.y1 - cb.y0);
              int32_t* d = t1.data.data();
              if (cp.roishift) {
                if (cp.roishift >= 31) {
                  std::fill(t1.data.begin(), t1.data.end(), 0);
                } else {
                  int32_t thresh = 1 << cp.roishift;
                  for (size_t i = 0; i < (size_t)w * h; i++) {
                    int32_t v = d[i];
                    int32_t mag = v < 0 ? -v : v;
                    if (mag >= thresh) {
                      mag >>= cp.roishift;
                      d[i] = v < 0 ? -mag : mag;
                    }
                  }
                }
              }
              int32_t x = cb.x0 - bd.x0, y = cb.y0 - bd.y0;
              if (bd.bandno & 1) x += tc.res[r - 1].x1 - tc.res[r - 1].x0;
              if (bd.bandno & 2) y += tc.res[r - 1].y1 - tc.res[r - 1].y0;
              if (cp.qmfbid == 1) {
                for (uint32_t j = 0; j < h; j++)
                  for (uint32_t i = 0; i < w; i++)
                    tc.idata[(size_t)(y + j) * tw_ + x + i] = d[(size_t)j * w + i] / 2;
              } else {
                const float step = 0.5f * bd.stepsize;
                for (uint32_t j = 0; j < h; j++)
                  for (uint32_t i = 0; i < w; i++)
                    tc.fdata[(size_t)(y + j) * tw_ + x + i] =
                        (float)d[(size_t)j * w + i] * step;
              }
              std::vector<uint8_t>().swap(cb.data);
            }
        }
      }
      if (cp.qmfbid == 1)
        idwt2d(tc, tc.idata.data(), idwt53, vert53);
      else
        idwt2d(tc, tc.fdata.data(), idwt97, vert97);
    }
    // multiple component transform
    if (tcp.mct) {
      if (numcomps() >= 3) {
        if (tiles[0].numres != tiles[1].numres ||
            tiles[0].numres != tiles[2].numres)
          fail("Tiles don't all have the same dimension. Skip the MCT step.");
        for (int c = 1; c < 3; c++)
          if ((int64_t)(tiles[c].x1 - tiles[c].x0) * (tiles[c].y1 - tiles[c].y0) !=
              (int64_t)(tiles[0].x1 - tiles[0].x0) * (tiles[0].y1 - tiles[0].y0))
            fail("Tiles don't all have the same dimension. Skip the MCT step.");
        size_t n = (size_t)(tiles[0].x1 - tiles[0].x0) * (tiles[0].y1 - tiles[0].y0);
        if (tcp.tccps[0].qmfbid == 1) {
          int32_t* c0 = tiles[0].idata.data();
          int32_t* c1 = tiles[1].idata.data();
          int32_t* c2 = tiles[2].idata.data();
          if (tiles[1].idata.size() < n || tiles[2].idata.size() < n)
            fail("mixed wavelets under the MCT");
          for (size_t i = 0; i < n; i++) {
            int32_t yv = c0[i], u = c1[i], v = c2[i];
            int32_t g = yv - ((u + v) >> 2);
            int32_t r = v + g, b = u + g;
            c0[i] = r;
            c1[i] = g;
            c2[i] = b;
          }
        } else {
          float* c0 = tiles[0].fdata.data();
          float* c1 = tiles[1].fdata.data();
          float* c2 = tiles[2].fdata.data();
          if (tiles[1].fdata.size() < n || tiles[2].fdata.size() < n)
            fail("mixed wavelets under the MCT");
          for (size_t i = 0; i < n; i++) {
            float yv = c0[i], u = c1[i], v = c2[i];
            float r = yv + (v * 1.402f);
            float g = yv - (u * 0.34413f) - (v * (0.71414f));
            float b = yv + (u * 1.772f);
            c0[i] = r;
            c1[i] = g;
            c2[i] = b;
          }
        }
      }
    }
    // DC level shift, clamp, and into the image
    for (uint32_t c = 0; c < numcomps(); c++) {
      TileComp& tc = tiles[c];
      Comp& ic = comps[c];
      const TCCP& cp = tcp.tccps[c];
      int32_t lmin, lmax;
      if (ic.sgnd) {
        lmin = -(int32_t)(1u << (ic.prec - 1));
        lmax = (int32_t)((1u << (ic.prec - 1)) - 1);
      } else {
        lmin = 0;
        lmax = (int32_t)((1u << ic.prec) - 1);
      }
      size_t w = (size_t)(tc.x1 - tc.x0), h = (size_t)(tc.y1 - tc.y0);
      int32_t ox = tc.x0 - (int32_t)ic.x0, oy = tc.y0 - (int32_t)ic.y0;
      for (size_t j = 0; j < h; j++) {
        int32_t* dst = ic.data.data() + (size_t)(oy + j) * ic.w + ox;
        if (cp.qmfbid == 1) {
          const int32_t* s = tc.idata.data() + j * w;
          for (size_t i = 0; i < w; i++) {
            int32_t v = (int32_t)((uint32_t)s[i] + (uint32_t)cp.dc_shift);
            dst[i] = v < lmin ? lmin : v > lmax ? lmax : v;
          }
        } else {
          const float* s = tc.fdata.data() + j * w;
          for (size_t i = 0; i < w; i++) {
            float v = s[i];
            if (v > (float)INT32_MAX)
              dst[i] = lmax;
            else if (v < (float)INT32_MIN)
              dst[i] = lmin;
            else {
              int64_t iv = (int64_t)lrintf(v) + cp.dc_shift;
              dst[i] = (int32_t)(iv < lmin ? lmin : iv > lmax ? lmax : iv);
            }
          }
        }
      }
    }
  }

  void run() {
    read_main_header();
    for (auto& c : comps) {
      if ((uint64_t)c.w * c.h > ((uint64_t)1 << 31)) fail("image too large");
      c.data.assign((size_t)c.w * c.h, 0);
    }
    read_tiles();
    for (uint32_t t : order) decode_tile(t);
  }
};

}  // namespace

extern "C" {

// Decodes a JPEG 2000 codestream (`ihdr_w`/`ihdr_h`: the JP2 ihdr box's
// size, or 0 for a raw codestream).  Returns a handle, or NULL with the
// cause in `err`; `*code` is 0, 1 (refused) or 2 (not yet read).
void* mn_j2k_decode(const uint8_t* buf, size_t len, uint32_t ihdr_w,
                    uint32_t ihdr_h, int* code, char* err, int errlen) {
  Decoder* d = new Decoder();
  d->buf = buf;
  d->len = len;
  d->ihdr_w = ihdr_w;
  d->ihdr_h = ihdr_h;
  *code = 0;
  try {
    d->run();
    return d;
  } catch (const Fail& f) {
    std::snprintf(err, (size_t)errlen, "%s", f.msg.c_str());
    *code = 1;
  } catch (const NotYet& f) {
    std::snprintf(err, (size_t)errlen, "%s", f.msg.c_str());
    *code = NOT_YET;
  } catch (const std::bad_alloc&) {
    std::snprintf(err, (size_t)errlen, "out of memory");
    *code = 1;
  }
  delete d;
  return nullptr;
}

// image x0, y0, x1, y1, numcomps, then per component prec, sgnd, dx, dy,
// x0, y0, w, h; returns the number of ints written
int mn_j2k_info(void* h, int32_t* info, int cap) {
  Decoder* d = (Decoder*)h;
  int n = 0;
  auto put = [&](uint32_t v) {
    if (n < cap) info[n] = (int32_t)v;
    n++;
  };
  put(d->x0);
  put(d->y0);
  put(d->x1);
  put(d->y1);
  put(d->numcomps());
  for (auto& c : d->comps) {
    put(c.prec);
    put(c.sgnd);
    put(c.dx);
    put(c.dy);
    put(c.x0);
    put(c.y0);
    put(c.w);
    put(c.h);
  }
  return n;
}

void mn_j2k_copy(void* h, int comp, int32_t* dst) {
  Decoder* d = (Decoder*)h;
  const Comp& c = d->comps[(size_t)comp];
  std::memcpy(dst, c.data.data(), c.data.size() * sizeof(int32_t));
}

void mn_j2k_free(void* h) { delete (Decoder*)h; }

}  // extern "C"

// JPEG 2000 codestream decoding for the port's `data/jp2.py`, written
// from ITU-T T.800 (Part 1) and T.814 (Part 15, HTJ2K) for the port,
// with OpenJPEG 2.5's arithmetic wherever it decides the bits that
// cv2.imread returns (OpenCV 5.0 reads JPEG 2000 through OpenJPEG 2.5.3;
// no OpenJPEG is vendored or linked):
//
// - tier 1 (T.800 Annex D): the MQ decoder (C.3, INITDEC/BYTEIN with an
//   artificial 0xFF 0xFF after each segment), the significance,
//   refinement and cleanup passes in stripes of 4 rows, BYPASS (raw
//   passes after the fourth bit-plane), RESET, TERMALL, VSC, PTERM and
//   SEGSYM; coefficients carry one fractional bit, so that a sample made
//   significant at bit-plane p holds 1.5 * 2^p and each refinement adds
//   or takes 2^(p-1) (OpenJPEG's reconstruction point);
// - HT code-blocks (code-block style 0x40; T.814 clause 7): the cleanup
//   pass (MEL, the VLC with OpenJPEG's two context tables, UVLC,
//   MagSgn), SigProp and MagRef, each stream unstuffed as
//   opj_t1_ht_decode_cblk unstuffs it, and its limits refused (ROI, more
//   than 3 passes, Mb over 30, Scup, MEL, U_q and VLC checks); the mixed
//   HT bit (0x80) is refused where the COD/COC is read;
// - RGN max-shift: |v| >= 2^s is shifted down by s, in that doubled scale;
// - tier 2 (Annex B): tag trees, inclusion, zero bit-planes, passes and
//   Lblock, segments (BYPASS, TERMALL; HT: a packet's first segment one
//   cleanup pass, a later one the rest), SOP/EPH, PPM/PPT packed headers,
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
//   is left as it is); stopped, as OpenJPEG stops it, at the highest
//   resolution that had a packet;
// - RCT / ICT (ICT in float as opj_mct_decode_real orders it), the DC
//   level shift and the clamp to the precision, the float samples
//   rounded by lrintf (half to even);
// - Part 2 markers as OpenJPEG 2.5.3 reads them: MCT, MCC and MCO
//   (an MCC collection's offset array becomes the DC level shifts, MCO
//   zeroes them), CBD (the components' precision and sign); CAP, CPF and
//   Rsiz's Part 2 and HT bits change nothing; COD's MCT byte 2 and the
//   ATK wavelets (COD/COC transform 2+) are refused.
//
// Float code must not be contracted into fused multiply-adds: the
// library is built with -ffp-contract=off and no -march (SSE2 on x86-64),
// as `data/jp2.py`'s CXX_FLAGS say.
//
// What OpenJPEG refuses in its strict mode is refused here: truncated
// tile-parts, segments past the tile's data, markers out of place or of
// bad sizes.

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

// Part 2 records as OpenJPEG keeps them (opj_mct_data_t and
// opj_simple_mcc_decorrelation_data_t), a collection's arrays as indices
// into the MCT records
struct MctRecord {
  uint32_t index = 0, element_type = 0;
  std::vector<uint8_t> data;
};

struct MccRecord {
  uint32_t index = 0, nb_comps = 0;
  int deco = -1, offset = -1;
};

// bytes per MCT element: int16, int32, float32, float64 (Imct bits 10-11)
const uint32_t MCT_ELEMENT_SIZE[4] = {2, 4, 4, 8};

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
  // MCT and MCC records; `mccs` keeps one slot past `nb_mcc`, which a
  // collection being read fills before it counts
  std::vector<MctRecord> mcts;
  std::vector<MccRecord> mccs;
  uint32_t nb_mcc = 0;
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
  uint32_t Mb = 0;  // the band's Mb, set where the code-block is included
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

// ------------------------------------------------------------------ HTJ2K
//
// HT code-blocks (ITU-T T.814, JPEG 2000 Part 15), decoded as OpenJPEG
// 2.5.3's opj_t1_ht_decode_cblk decodes them: the cleanup pass (MEL
// events, the VLC read backwards from the end of the cleanup segment,
// UVLC and MagSgn), then the SigProp and MagRef passes of the second
// segment.  A sample holds sign | magnitude with one fractional bit, as
// the Part 1 decoder's do: (2 mu + 1) << (p - 1) after the cleanup pass,
// where p is the code-block's number of bit-planes (numbps).
//
// The two context VLC tables are OpenJPEG's vlc_tbl0 / vlc_tbl1
// (t1_ht_luts.h: bits 0-2 the codeword length, 3 u_off, 4-7 rho, 8-11
// e_1, 12-15 e_k; index context << 7 | the next 7 bits).  They were read
// out of the OpenJPEG 2.5.3 linked into OpenCV 5.0.0's cv2 module (file
// offsets 0x3ff5800 and 0x3ff5000 of cv2.abi3.so) and agree entry for
// entry with the copy in Pillow's libopenjp2 2.5.4 and with FFmpeg's
// dec_cxt_vlc_table0 / 1 (libavcodec 62, whose entries pack the same
// fields as u_off | len << 1 | rho << 4 | e_k << 8 | e_1 << 12).

const uint16_t VLC_TBL0[1024] = {
    0x0023, 0x00a5, 0x0043, 0x0066, 0x0083, 0xa8ee, 0x0014, 0xd8df,
    0x0023, 0x10be, 0x0043, 0xf5ff, 0x0083, 0x207e, 0x0055, 0x515f,
    0x0023, 0x0035, 0x0043, 0x444e, 0x0083, 0xc4ce, 0x0014, 0xcccf,
    0x0023, 0xe2fe, 0x0043, 0x99ff, 0x0083, 0x0096, 0x00c5, 0x313f,
    0x0023, 0x00a5, 0x0043, 0x445e, 0x0083, 0xc8ce, 0x0014, 0x11df,
    0x0023, 0xf4fe, 0x0043, 0xfcff, 0x0083, 0x009e, 0x0055, 0x0077,
    0x0023, 0x0035, 0x0043, 0xf1ff, 0x0083, 0x88ae, 0x0014, 0x00b7,
    0x0023, 0xf8fe, 0x0043, 0xe4ef, 0x0083, 0x888e, 0x00c5, 0x111f,
    0x0023, 0x00a5, 0x0043, 0x0066, 0x0083, 0xa8ee, 0x0014, 0x54df,
    0x0023, 0x10be, 0x0043, 0x22ef, 0x0083, 0x207e, 0x0055, 0x227f,
    0x0023, 0x0035, 0x0043, 0x444e, 0x0083, 0xc4ce, 0x0014, 0x11bf,
    0x0023, 0xe2fe, 0x0043, 0x00f7, 0x0083, 0x0096, 0x00c5, 0x223f,
    0x0023, 0x00a5, 0x0043, 0x445e, 0x0083, 0xc8ce, 0x0014, 0x00d7,
    0x0023, 0xf4fe, 0x0043, 0xbaff, 0x0083, 0x009e, 0x0055, 0x006f,
    0x0023, 0x0035, 0x0043, 0xe6ff, 0x0083, 0x88ae, 0x0014, 0xa2af,
    0x0023, 0xf8fe, 0x0043, 0x00e7, 0x0083, 0x888e, 0x00c5, 0x222f,
    0x0002, 0x00c5, 0x0084, 0x207e, 0x0002, 0xc4ce, 0x0024, 0x00f7,
    0x0002, 0xa2fe, 0x0044, 0x0056, 0x0002, 0x009e, 0x0014, 0x00d7,
    0x0002, 0x10be, 0x0084, 0x0066, 0x0002, 0x88ae, 0x0024, 0x11df,
    0x0002, 0xa8ee, 0x0044, 0x0036, 0x0002, 0x888e, 0x0014, 0x111f,
    0x0002, 0x00c5, 0x0084, 0x006e, 0x0002, 0x88ce, 0x0024, 0x88ff,
    0x0002, 0xb8fe, 0x0044, 0x444e, 0x0002, 0x0096, 0x0014, 0x00b7,
    0x0002, 0xe4fe, 0x0084, 0x445e, 0x0002, 0x00a6, 0x0024, 0x00e7,
    0x0002, 0x54de, 0x0044, 0x222e, 0x0002, 0x003e, 0x0014, 0x0077,
    0x0002, 0x00c5, 0x0084, 0x207e, 0x0002, 0xc4ce, 0x0024, 0xf1ff,
    0x0002, 0xa2fe, 0x0044, 0x0056, 0x0002, 0x009e, 0x0014, 0x11bf,
    0x0002, 0x10be, 0x0084, 0x0066, 0x0002, 0x88ae, 0x0024, 0x22ef,
    0x0002, 0xa8ee, 0x0044, 0x0036, 0x0002, 0x888e, 0x0014, 0x227f,
    0x0002, 0x00c5, 0x0084, 0x006e, 0x0002, 0x88ce, 0x0024, 0xe4ef,
    0x0002, 0xb8fe, 0x0044, 0x444e, 0x0002, 0x0096, 0x0014, 0xa2af,
    0x0002, 0xe4fe, 0x0084, 0x445e, 0x0002, 0x00a6, 0x0024, 0xd8df,
    0x0002, 0x54de, 0x0044, 0x222e, 0x0002, 0x003e, 0x0014, 0x515f,
    0x0002, 0x0055, 0x0084, 0x0066, 0x0002, 0x88de, 0x0024, 0x32ff,
    0x0002, 0x11fe, 0x0044, 0x444e, 0x0002, 0x00ae, 0x0014, 0x00b7,
    0x0002, 0x317e, 0x0084, 0x515e, 0x0002, 0x00c6, 0x0024, 0x00d7,
    0x0002, 0x20ee, 0x0044, 0x111e, 0x0002, 0x009e, 0x0014, 0x0077,
    0x0002, 0x0055, 0x0084, 0x545e, 0x0002, 0x44ce, 0x0024, 0x00e7,
    0x0002, 0xf1fe, 0x0044, 0x0036, 0x0002, 0x00a6, 0x0014, 0x555f,
    0x0002, 0x74fe, 0x0084, 0x113e, 0x0002, 0x20be, 0x0024, 0x747f,
    0x0002, 0xc4de, 0x0044, 0xf8ff, 0x0002, 0x0096, 0x0014, 0x222f,
    0x0002, 0x0055, 0x0084, 0x0066, 0x0002, 0x88de, 0x0024, 0x00f7,
    0x0002, 0x11fe, 0x0044, 0x444e, 0x0002, 0x00ae, 0x0014, 0x888f,
    0x0002, 0x317e, 0x0084, 0x515e, 0x0002, 0x00c6, 0x0024, 0xc8cf,
    0x0002, 0x20ee, 0x0044, 0x111e, 0x0002, 0x009e, 0x0014, 0x006f,
    0x0002, 0x0055, 0x0084, 0x545e, 0x0002, 0x44ce, 0x0024, 0xd1df,
    0x0002, 0xf1fe, 0x0044, 0x0036, 0x0002, 0x00a6, 0x0014, 0x227f,
    0x0002, 0x74fe, 0x0084, 0x113e, 0x0002, 0x20be, 0x0024, 0x22bf,
    0x0002, 0xc4de, 0x0044, 0x22ef, 0x0002, 0x0096, 0x0014, 0x323f,
    0x0003, 0xd4de, 0xf4fd, 0xfcff, 0x0014, 0x113e, 0x0055, 0x888f,
    0x0003, 0x32be, 0x0085, 0x00e7, 0x0025, 0x515e, 0xaafe, 0x727f,
    0x0003, 0x44ce, 0xf8fd, 0x44ef, 0x0014, 0x647e, 0x0045, 0xa2af,
    0x0003, 0x00a6, 0x555d, 0x99df, 0xf1fd, 0x0036, 0xf5fe, 0x626f,
    0x0003, 0xd1de, 0xf4fd, 0xe6ff, 0x0014, 0x717e, 0x0055, 0xb1bf,
    0x0003, 0x88ae, 0x0085, 0xd5df, 0x0025, 0x444e, 0xf2fe, 0x667f,
    0x0003, 0x00c6, 0xf8fd, 0xe2ef, 0x0014, 0x545e, 0x0045, 0x119f,
    0x0003, 0x0096, 0x555d, 0xc8cf, 0xf1fd, 0x111e, 0xc8ee, 0x0067,
    0x0003, 0xd4de, 0xf4fd, 0xf3ff, 0x0014, 0x113e, 0x0055, 0x11bf,
    0x0003, 0x32be, 0x0085, 0xd8df, 0x0025, 0x515e, 0xaafe, 0x222f,
    0x0003, 0x44ce, 0xf8fd, 0x00f7, 0x0014, 0x647e, 0x0045, 0x989f,
    0x0003, 0x00a6, 0x555d, 0x00d7, 0xf1fd, 0x0036, 0xf5fe, 0x446f,
    0x0003, 0xd1de, 0xf4fd, 0xb9ff, 0x0014, 0x717e, 0x0055, 0x00b7,
    0x0003, 0x88ae, 0x0085, 0xdcdf, 0x0025, 0x444e, 0xf2fe, 0x0077,
    0x0003, 0x00c6, 0xf8fd, 0xe4ef, 0x0014, 0x545e, 0x0045, 0x737f,
    0x0003, 0x0096, 0x555d, 0xb8bf, 0xf1fd, 0x111e, 0xc8ee, 0x323f,
    0x0002, 0x00a5, 0x0084, 0x407e, 0x0002, 0x10de, 0x0024, 0x11df,
    0x0002, 0x72fe, 0x0044, 0x0056, 0x0002, 0xa8ae, 0x0014, 0xb2bf,
    0x0002, 0x0096, 0x0084, 0x0066, 0x0002, 0x00c6, 0x0024, 0x00e7,
    0x0002, 0xc8ee, 0x0044, 0x222e, 0x0002, 0x888e, 0x0014, 0x0077,
    0x0002, 0x00a5, 0x0084, 0x006e, 0x0002, 0x88ce, 0x0024, 0x00f7,
    0x0002, 0x91fe, 0x0044, 0x0036, 0x0002, 0xa2ae, 0x0014, 0xaaaf,
    0x0002, 0xb8fe, 0x0084, 0x005e, 0x0002, 0x00be, 0x0024, 0xc4cf,
    0x0002, 0x44ee, 0x0044, 0xf4ff, 0x0002, 0x223e, 0x0014, 0x111f,
    0x0002, 0x00a5, 0x0084, 0x407e, 0x0002, 0x10de, 0x0024, 0x99ff,
    0x0002, 0x72fe, 0x0044, 0x0056, 0x0002, 0xa8ae, 0x0014, 0x00b7,
    0x0002, 0x0096, 0x0084, 0x0066, 0x0002, 0x00c6, 0x0024, 0x00d7,
    0x0002, 0xc8ee, 0x0044, 0x222e, 0x0002, 0x888e, 0x0014, 0x444f,
    0x0002, 0x00a5, 0x0084, 0x006e, 0x0002, 0x88ce, 0x0024, 0xe2ef,
    0x0002, 0x91fe, 0x0044, 0x0036, 0x0002, 0xa2ae, 0x0014, 0x447f,
    0x0002, 0xb8fe, 0x0084, 0x005e, 0x0002, 0x00be, 0x0024, 0x009f,
    0x0002, 0x44ee, 0x0044, 0x76ff, 0x0002, 0x223e, 0x0014, 0x313f,
    0x0003, 0x00c6, 0x0085, 0xd9ff, 0xf2fd, 0x647e, 0xf1fe, 0x99bf,
    0x0003, 0xa2ae, 0x0025, 0x66ef, 0xf4fd, 0x0056, 0xe2ee, 0x737f,
    0x0003, 0x98be, 0x0045, 0x00f7, 0xf8fd, 0x0066, 0x76fe, 0x889f,
    0x0003, 0x888e, 0x0015, 0xd5df, 0x00a5, 0x222e, 0x98de, 0x444f,
    0x0003, 0xb2be, 0x0085, 0xfcff, 0xf2fd, 0x226e, 0x0096, 0x00b7,
    0x0003, 0xaaae, 0x0025, 0xd1df, 0xf4fd, 0x0036, 0xd4de, 0x646f,
    0x0003, 0xa8ae, 0x0045, 0xeaef, 0xf8fd, 0x445e, 0xe8ee, 0x717f,
    0x0003, 0x323e, 0x0015, 0xc4cf, 0x00a5, 0xfaff, 0x88ce, 0x313f,
    0x0003, 0x00c6, 0x0085, 0x77ff, 0xf2fd, 0x647e, 0xf1fe, 0xb3bf,
    0x0003, 0xa2ae, 0x0025, 0x00e7, 0xf4fd, 0x0056, 0xe2ee, 0x0077,
    0x0003, 0x98be, 0x0045, 0xe4ef, 0xf8fd, 0x0066, 0x76fe, 0x667f,
    0x0003, 0x888e, 0x0015, 0x00d7, 0x00a5, 0x222e, 0x98de, 0x333f,
    0x0003, 0xb2be, 0x0085, 0x75ff, 0xf2fd, 0x226e, 0x0096, 0x919f,
    0x0003, 0xaaae, 0x0025, 0x99df, 0xf4fd, 0x0036, 0xd4de, 0x515f,
    0x0003, 0xa8ae, 0x0045, 0xecef, 0xf8fd, 0x445e, 0xe8ee, 0x727f,
    0x0003, 0x323e, 0x0015, 0xb1bf, 0x00a5, 0xf3ff, 0x88ce, 0x111f,
    0x0003, 0x54de, 0xf2fd, 0x111e, 0x0014, 0x647e, 0xf8fe, 0xcccf,
    0x0003, 0x91be, 0x0045, 0x22ef, 0x0025, 0x222e, 0xf3fe, 0x888f,
    0x0003, 0x00c6, 0x0085, 0x00f7, 0x0014, 0x115e, 0xfcfe, 0xa8af,
    0x0003, 0x00a6, 0x0035, 0xc8df, 0xf1fd, 0x313e, 0x66fe, 0x646f,
    0x0003, 0xc8ce, 0xf2fd, 0xf5ff, 0x0014, 0x0066, 0xf4fe, 0xbabf,
    0x0003, 0x22ae, 0x0045, 0x00e7, 0x0025, 0x323e, 0xeafe, 0x737f,
    0x0003, 0xb2be, 0x0085, 0x55df, 0x0014, 0x0056, 0x717e, 0x119f,
    0x0003, 0x0096, 0x0035, 0xc4cf, 0xf1fd, 0x333e, 0xe8ee, 0x444f,
    0x0003, 0x54de, 0xf2fd, 0x111e, 0x0014, 0x647e, 0xf8fe, 0x99bf,
    0x0003, 0x91be, 0x0045, 0xe2ef, 0x0025, 0x222e, 0xf3fe, 0x667f,
    0x0003, 0x00c6, 0x0085, 0xe4ef, 0x0014, 0x115e, 0xfcfe, 0x989f,
    0x0003, 0x00a6, 0x0035, 0x00d7, 0xf1fd, 0x313e, 0x66fe, 0x226f,
    0x0003, 0xc8ce, 0xf2fd, 0xb9ff, 0x0014, 0x0066, 0xf4fe, 0x00b7,
    0x0003, 0x22ae, 0x0045, 0xd1df, 0x0025, 0x323e, 0xeafe, 0x0077,
    0x0003, 0xb2be, 0x0085, 0xecef, 0x0014, 0x0056, 0x717e, 0x727f,
    0x0003, 0x0096, 0x0035, 0xb8bf, 0xf1fd, 0x333e, 0xe8ee, 0x545f,
    0xf1fc, 0xd1de, 0xfafd, 0x00d7, 0xf8fc, 0x0016, 0xfffd, 0x747f,
    0xf4fc, 0x717e, 0xf3fd, 0xb3bf, 0xf2fc, 0xeaef, 0xe8ee, 0x444f,
    0xf1fc, 0x22ae, 0x0005, 0xb8bf, 0xf8fc, 0x00f7, 0xfcfe, 0x0077,
    0xf4fc, 0x115e, 0xf5fd, 0x757f, 0xf2fc, 0xd8df, 0xe2ee, 0x333f,
    0xf1fc, 0xb2be, 0xfafd, 0x88cf, 0xf8fc, 0xfbff, 0xfffd, 0x737f,
    0xf4fc, 0x006e, 0xf3fd, 0x00b7, 0xf2fc, 0x66ef, 0xf9fe, 0x313f,
    0xf1fc, 0x009e, 0x0005, 0xbabf, 0xf8fc, 0xfdff, 0xf6fe, 0x0067,
    0xf4fc, 0x0026, 0xf5fd, 0x888f, 0xf2fc, 0xdcdf, 0xd4de, 0x222f,
    0xf1fc, 0xd1de, 0xfafd, 0xc4cf, 0xf8fc, 0x0016, 0xfffd, 0x727f,
    0xf4fc, 0x717e, 0xf3fd, 0x99bf, 0xf2fc, 0xecef, 0xe8ee, 0x0047,
    0xf1fc, 0x22ae, 0x0005, 0x00a7, 0xf8fc, 0xf7ff, 0xfcfe, 0x0057,
    0xf4fc, 0x115e, 0xf5fd, 0x0097, 0xf2fc, 0xd5df, 0xe2ee, 0x0037,
    0xf1fc, 0xb2be, 0xfafd, 0x00c7, 0xf8fc, 0xfeff, 0xfffd, 0x667f,
    0xf4fc, 0x006e, 0xf3fd, 0xa8af, 0xf2fc, 0x00e7, 0xf9fe, 0x323f,
    0xf1fc, 0x009e, 0x0005, 0xb1bf, 0xf8fc, 0xe4ef, 0xf6fe, 0x545f,
    0xf4fc, 0x0026, 0xf5fd, 0x0087, 0xf2fc, 0x99df, 0xd4de, 0x111f
};
const uint16_t VLC_TBL1[1024] = {
    0x0013, 0x0065, 0x0043, 0x00de, 0x0083, 0x888d, 0x0023, 0x444e,
    0x0013, 0x00a5, 0x0043, 0x88ae, 0x0083, 0x0035, 0x0023, 0x00d7,
    0x0013, 0x00c5, 0x0043, 0x009e, 0x0083, 0x0055, 0x0023, 0x222e,
    0x0013, 0x0095, 0x0043, 0x007e, 0x0083, 0x10fe, 0x0023, 0x0077,
    0x0013, 0x0065, 0x0043, 0x88ce, 0x0083, 0x888d, 0x0023, 0x111e,
    0x0013, 0x00a5, 0x0043, 0x005e, 0x0083, 0x0035, 0x0023, 0x00e7,
    0x0013, 0x00c5, 0x0043, 0x00be, 0x0083, 0x0055, 0x0023, 0x11ff,
    0x0013, 0x0095, 0x0043, 0x003e, 0x0083, 0x40ee, 0x0023, 0xa2af,
    0x0013, 0x0065, 0x0043, 0x00de, 0x0083, 0x888d, 0x0023, 0x444e,
    0x0013, 0x00a5, 0x0043, 0x88ae, 0x0083, 0x0035, 0x0023, 0x44ef,
    0x0013, 0x00c5, 0x0043, 0x009e, 0x0083, 0x0055, 0x0023, 0x222e,
    0x0013, 0x0095, 0x0043, 0x007e, 0x0083, 0x10fe, 0x0023, 0x00b7,
    0x0013, 0x0065, 0x0043, 0x88ce, 0x0083, 0x888d, 0x0023, 0x111e,
    0x0013, 0x00a5, 0x0043, 0x005e, 0x0083, 0x0035, 0x0023, 0xc4cf,
    0x0013, 0x00c5, 0x0043, 0x00be, 0x0083, 0x0055, 0x0023, 0x00f7,
    0x0013, 0x0095, 0x0043, 0x003e, 0x0083, 0x40ee, 0x0023, 0x006f,
    0x0001, 0x0084, 0x0001, 0x0056, 0x0001, 0x0014, 0x0001, 0x00d7,
    0x0001, 0x0024, 0x0001, 0x0096, 0x0001, 0x0045, 0x0001, 0x0077,
    0x0001, 0x0084, 0x0001, 0x00c6, 0x0001, 0x0014, 0x0001, 0x888f,
    0x0001, 0x0024, 0x0001, 0x00f7, 0x0001, 0x0035, 0x0001, 0x222f,
    0x0001, 0x0084, 0x0001, 0x40fe, 0x0001, 0x0014, 0x0001, 0x00b7,
    0x0001, 0x0024, 0x0001, 0x00bf, 0x0001, 0x0045, 0x0001, 0x0067,
    0x0001, 0x0084, 0x0001, 0x00a6, 0x0001, 0x0014, 0x0001, 0x444f,
    0x0001, 0x0024, 0x0001, 0x00e7, 0x0001, 0x0035, 0x0001, 0x113f,
    0x0001, 0x0084, 0x0001, 0x0056, 0x0001, 0x0014, 0x0001, 0x00cf,
    0x0001, 0x0024, 0x0001, 0x0096, 0x0001, 0x0045, 0x0001, 0x006f,
    0x0001, 0x0084, 0x0001, 0x00c6, 0x0001, 0x0014, 0x0001, 0x009f,
    0x0001, 0x0024, 0x0001, 0x00ef, 0x0001, 0x0035, 0x0001, 0x323f,
    0x0001, 0x0084, 0x0001, 0x40fe, 0x0001, 0x0014, 0x0001, 0x00af,
    0x0001, 0x0024, 0x0001, 0x44ff, 0x0001, 0x0045, 0x0001, 0x005f,
    0x0001, 0x0084, 0x0001, 0x00a6, 0x0001, 0x0014, 0x0001, 0x007f,
    0x0001, 0x0024, 0x0001, 0x00df, 0x0001, 0x0035, 0x0001, 0x111f,
    0x0001, 0x0024, 0x0001, 0x0056, 0x0001, 0x0085, 0x0001, 0x00bf,
    0x0001, 0x0014, 0x0001, 0x00f7, 0x0001, 0x00c6, 0x0001, 0x0077,
    0x0001, 0x0024, 0x0001, 0xf8ff, 0x0001, 0x0045, 0x0001, 0x007f,
    0x0001, 0x0014, 0x0001, 0x00df, 0x0001, 0x00a6, 0x0001, 0x313f,
    0x0001, 0x0024, 0x0001, 0x222e, 0x0001, 0x0085, 0x0001, 0x00b7,
    0x0001, 0x0014, 0x0001, 0x44ef, 0x0001, 0xa2ae, 0x0001, 0x0067,
    0x0001, 0x0024, 0x0001, 0x51ff, 0x0001, 0x0045, 0x0001, 0x0097,
    0x0001, 0x0014, 0x0001, 0x00cf, 0x0001, 0x0036, 0x0001, 0x223f,
    0x0001, 0x0024, 0x0001, 0x0056, 0x0001, 0x0085, 0x0001, 0xb2bf,
    0x0001, 0x0014, 0x0001, 0x40ef, 0x0001, 0x00c6, 0x0001, 0x006f,
    0x0001, 0x0024, 0x0001, 0x72ff, 0x0001, 0x0045, 0x0001, 0x009f,
    0x0001, 0x0014, 0x0001, 0x00d7, 0x0001, 0x00a6, 0x0001, 0x444f,
    0x0001, 0x0024, 0x0001, 0x222e, 0x0001, 0x0085, 0x0001, 0xa8af,
    0x0001, 0x0014, 0x0001, 0x00e7, 0x0001, 0xa2ae, 0x0001, 0x005f,
    0x0001, 0x0024, 0x0001, 0x44ff, 0x0001, 0x0045, 0x0001, 0x888f,
    0x0001, 0x0014, 0x0001, 0xaaaf, 0x0001, 0x0036, 0x0001, 0x111f,
    0x0002, 0xf8fe, 0x0024, 0x0056, 0x0002, 0x00b6, 0x0085, 0x66ff,
    0x0002, 0x00ce, 0x0014, 0x111e, 0x0002, 0x0096, 0x0035, 0xa8af,
    0x0002, 0x00f6, 0x0024, 0x313e, 0x0002, 0x00a6, 0x0045, 0xb3bf,
    0x0002, 0xb2be, 0x0014, 0xf5ff, 0x0002, 0x0066, 0x517e, 0x545f,
    0x0002, 0xf2fe, 0x0024, 0x222e, 0x0002, 0x22ae, 0x0085, 0x44ef,
    0x0002, 0x00c6, 0x0014, 0xf4ff, 0x0002, 0x0076, 0x0035, 0x447f,
    0x0002, 0x40de, 0x0024, 0x323e, 0x0002, 0x009e, 0x0045, 0x00d7,
    0x0002, 0x88be, 0x0014, 0xfaff, 0x0002, 0x115e, 0xf1fe, 0x444f,
    0x0002, 0xf8fe, 0x0024, 0x0056, 0x0002, 0x00b6, 0x0085, 0xc8ef,
    0x0002, 0x00ce, 0x0014, 0x111e, 0x0002, 0x0096, 0x0035, 0x888f,
    0x0002, 0x00f6, 0x0024, 0x313e, 0x0002, 0x00a6, 0x0045, 0x44df,
    0x0002, 0xb2be, 0x0014, 0xa8ff, 0x0002, 0x0066, 0x517e, 0x006f,
    0x0002, 0xf2fe, 0x0024, 0x222e, 0x0002, 0x22ae, 0x0085, 0x00e7,
    0x0002, 0x00c6, 0x0014, 0xe2ef, 0x0002, 0x0076, 0x0035, 0x727f,
    0x0002, 0x40de, 0x0024, 0x323e, 0x0002, 0x009e, 0x0045, 0xb1bf,
    0x0002, 0x88be, 0x0014, 0x73ff, 0x0002, 0x115e, 0xf1fe, 0x333f,
    0x0001, 0x0084, 0x0001, 0x20ee, 0x0001, 0x00c5, 0x0001, 0xc4cf,
    0x0001, 0x0044, 0x0001, 0x32ff, 0x0001, 0x0015, 0x0001, 0x888f,
    0x0001, 0x0084, 0x0001, 0x0066, 0x0001, 0x0025, 0x0001, 0x00af,
    0x0001, 0x0044, 0x0001, 0x22ef, 0x0001, 0x00a6, 0x0001, 0x005f,
    0x0001, 0x0084, 0x0001, 0x444e, 0x0001, 0x00c5, 0x0001, 0xcccf,
    0x0001, 0x0044, 0x0001, 0x00f7, 0x0001, 0x0015, 0x0001, 0x006f,
    0x0001, 0x0084, 0x0001, 0x0056, 0x0001, 0x0025, 0x0001, 0x009f,
    0x0001, 0x0044, 0x0001, 0x00df, 0x0001, 0x30fe, 0x0001, 0x222f,
    0x0001, 0x0084, 0x0001, 0x20ee, 0x0001, 0x00c5, 0x0001, 0xc8cf,
    0x0001, 0x0044, 0x0001, 0x11ff, 0x0001, 0x0015, 0x0001, 0x0077,
    0x0001, 0x0084, 0x0001, 0x0066, 0x0001, 0x0025, 0x0001, 0x007f,
    0x0001, 0x0044, 0x0001, 0x00e7, 0x0001, 0x00a6, 0x0001, 0x0037,
    0x0001, 0x0084, 0x0001, 0x444e, 0x0001, 0x00c5, 0x0001, 0x00b7,
    0x0001, 0x0044, 0x0001, 0x00bf, 0x0001, 0x0015, 0x0001, 0x003f,
    0x0001, 0x0084, 0x0001, 0x0056, 0x0001, 0x0025, 0x0001, 0x0097,
    0x0001, 0x0044, 0x0001, 0x00d7, 0x0001, 0x30fe, 0x0001, 0x111f,
    0x0002, 0xa8ee, 0x0044, 0x888e, 0x0002, 0x00d6, 0x00c5, 0xf3ff,
    0x0002, 0xfcfe, 0x0025, 0x003e, 0x0002, 0x00b6, 0x0055, 0xd8df,
    0x0002, 0xf8fe, 0x0044, 0x0066, 0x0002, 0x207e, 0x0085, 0x99ff,
    0x0002, 0x00e6, 0x00f5, 0x0036, 0x0002, 0x00a6, 0x0015, 0x009f,
    0x0002, 0xf2fe, 0x0044, 0x0076, 0x0002, 0x44ce, 0x00c5, 0x76ff,
    0x0002, 0xf1fe, 0x0025, 0x444e, 0x0002, 0x00ae, 0x0055, 0xc8cf,
    0x0002, 0xf4fe, 0x0044, 0x445e, 0x0002, 0x10be, 0x0085, 0xe4ef,
    0x0002, 0x54de, 0x00f5, 0x111e, 0x0002, 0x0096, 0x0015, 0x222f,
    0x0002, 0xa8ee, 0x0044, 0x888e, 0x0002, 0x00d6, 0x00c5, 0xfaff,
    0x0002, 0xfcfe, 0x0025, 0x003e, 0x0002, 0x00b6, 0x0055, 0x11bf,
    0x0002, 0xf8fe, 0x0044, 0x0066, 0x0002, 0x207e, 0x0085, 0x22ef,
    0x0002, 0x00e6, 0x00f5, 0x0036, 0x0002, 0x00a6, 0x0015, 0x227f,
    0x0002, 0xf2fe, 0x0044, 0x0076, 0x0002, 0x44ce, 0x00c5, 0xd5ff,
    0x0002, 0xf1fe, 0x0025, 0x444e, 0x0002, 0x00ae, 0x0055, 0x006f,
    0x0002, 0xf4fe, 0x0044, 0x445e, 0x0002, 0x10be, 0x0085, 0x11df,
    0x0002, 0x54de, 0x00f5, 0x111e, 0x0002, 0x0096, 0x0015, 0x515f,
    0x0003, 0x00f6, 0x0014, 0x111e, 0x0044, 0x888e, 0x00a5, 0xd4df,
    0x0003, 0xa2ae, 0x0055, 0x76ff, 0x0024, 0x223e, 0x00b6, 0xaaaf,
    0x0003, 0x00e6, 0x0014, 0xf5ff, 0x0044, 0x0066, 0x0085, 0xcccf,
    0x0003, 0x009e, 0x00c5, 0x44ef, 0x0024, 0x0036, 0xf8fe, 0x317f,
    0x0003, 0xe8ee, 0x0014, 0xf1ff, 0x0044, 0x0076, 0x00a5, 0xc4cf,
    0x0003, 0x227e, 0x0055, 0xd1df, 0x0024, 0x444e, 0xf4fe, 0x515f,
    0x0003, 0x00d6, 0x0014, 0xe2ef, 0x0044, 0x445e, 0x0085, 0x22bf,
    0x0003, 0x0096, 0x00c5, 0xc8df, 0x0024, 0x222e, 0xf2fe, 0x226f,
    0x0003, 0x00f6, 0x0014, 0x111e, 0x0044, 0x888e, 0x00a5, 0xb1bf,
    0x0003, 0xa2ae, 0x0055, 0x33ff, 0x0024, 0x223e, 0x00b6, 0xa8af,
    0x0003, 0x00e6, 0x0014, 0xb9ff, 0x0044, 0x0066, 0x0085, 0xa8bf,
    0x0003, 0x009e, 0x00c5, 0xe4ef, 0x0024, 0x0036, 0xf8fe, 0x646f,
    0x0003, 0xe8ee, 0x0014, 0xfcff, 0x0044, 0x0076, 0x00a5, 0xc8cf,
    0x0003, 0x227e, 0x0055, 0xeaef, 0x0024, 0x444e, 0xf4fe, 0x747f,
    0x0003, 0x00d6, 0x0014, 0xfaff, 0x0044, 0x445e, 0x0085, 0xb2bf,
    0x0003, 0x0096, 0x00c5, 0x44df, 0x0024, 0x222e, 0xf2fe, 0x313f,
    0x00f3, 0xfafe, 0xf1fd, 0x0036, 0x0004, 0x32be, 0x0075, 0x11df,
    0x00f3, 0x54de, 0xf2fd, 0xe4ef, 0x00d5, 0x717e, 0xfcfe, 0x737f,
    0x00f3, 0xf3fe, 0xf8fd, 0x111e, 0x0004, 0x0096, 0x0055, 0xb1bf,
    0x00f3, 0x00ce, 0x00b5, 0xd8df, 0xf4fd, 0x0066, 0xb9fe, 0x545f,
    0x00f3, 0x76fe, 0xf1fd, 0x0026, 0x0004, 0x00a6, 0x0075, 0x009f,
    0x00f3, 0x00ae, 0xf2fd, 0xf7ff, 0x00d5, 0x0046, 0xf5fe, 0x747f,
    0x00f3, 0x00e6, 0xf8fd, 0x0016, 0x0004, 0x0086, 0x0055, 0x888f,
    0x00f3, 0x00c6, 0x00b5, 0xe2ef, 0xf4fd, 0x115e, 0xa8ee, 0x113f,
    0x00f3, 0xfafe, 0xf1fd, 0x0036, 0x0004, 0x32be, 0x0075, 0xd1df,
    0x00f3, 0x54de, 0xf2fd, 0xfbff, 0x00d5, 0x717e, 0xfcfe, 0x447f,
    0x00f3, 0xf3fe, 0xf8fd, 0x111e, 0x0004, 0x0096, 0x0055, 0x727f,
    0x00f3, 0x00ce, 0x00b5, 0x22ef, 0xf4fd, 0x0066, 0xb9fe, 0x444f,
    0x00f3, 0x76fe, 0xf1fd, 0x0026, 0x0004, 0x00a6, 0x0075, 0x11bf,
    0x00f3, 0x00ae, 0xf2fd, 0xffff, 0x00d5, 0x0046, 0xf5fe, 0x323f,
    0x00f3, 0x00e6, 0xf8fd, 0x0016, 0x0004, 0x0086, 0x0055, 0x006f,
    0x00f3, 0x00c6, 0x00b5, 0xb8bf, 0xf4fd, 0x115e, 0xa8ee, 0x222f
};

// the MEL stream: forward, MSB first, from the start of MEL + VLC for
// Scup - 1 bytes (the last ORed with 0x0F, as it shares its low nibble
// with the VLC), then 0xFF; after a 0xFF byte the next byte's MSB is
// stuffed (ORed into the 0xFF's last bit)
struct HtMel {
  const uint8_t* p = nullptr;
  int size = 0;
  uint64_t tmp = 0;  // bits from the MSB down
  int bits = 0;
  bool unstuff = false;
  int k = 0;
  void push() {
    uint64_t d = size > 0 ? *p : 0xff;
    if (size == 1) d |= 0xf;
    if (size > 0) p++;
    size--;
    int db = 8 - (unstuff ? 1 : 0);
    tmp |= d << (56 - bits + (unstuff ? 1 : 0));
    bits += db;
    unstuff = (d & 0xff) == 0xff;
  }
  // OpenJPEG reads the first 1 to 4 bytes one at a time (as many as the
  // buffer's address leaves to a multiple of 4) and refuses the block
  // where one of them follows a 0xFF and exceeds 0x8F; the port refuses
  // it where any address would (the next byte is read even past the
  // MEL, as OpenJPEG reads it)
  bool init(const uint8_t* data, int lcup, int scup) {
    p = data + lcup - scup;
    size = scup - 1;
    for (int i = 0; i < 4; i++) {
      if (unstuff && p[0] > 0x8f) return false;
      push();
    }
    return true;
  }
  int run() {  // 2 n + 1: n 0 events then a 1; 2 n: n 0 events
    static const int EXP[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5};
    while (bits < 6) push();
    int e = EXP[k];
    if (tmp >> 63) {
      tmp <<= 1;
      bits -= 1;
      k = std::min(k + 1, 12);
      return ((1 << e) - 1) << 1;
    }
    int r = (int)(tmp >> (63 - e)) & ((1 << e) - 1);
    tmp <<= e + 1;
    bits -= e + 1;
    k = std::max(k - 1, 0);
    return (r << 1) + 1;
  }
};

// a stream read backwards (the VLC, the MagRef), LSB first: a byte after
// one over 0x8F gives 7 bits where its low 7 bits are all set (its MSB is
// ORed into the next byte's first bit); 0 past the end
struct HtRev {
  const uint8_t* p = nullptr;
  int size = 0;
  uint64_t tmp = 0;
  uint32_t bits = 0;
  bool unstuff = false;
  void push(uint64_t d) {
    uint32_t db = 8 - ((unstuff && (d & 0x7f) == 0x7f) ? 1 : 0);
    tmp |= d << bits;
    bits += db;
    unstuff = d > 0x8f;
  }
  void init_vlc(const uint8_t* data, int lcup, int scup) {
    p = data + lcup - 2;
    size = scup - 2;
    uint8_t d = *p--;
    tmp = d >> 4;
    bits = 4 - ((tmp & 7) == 7 ? 1 : 0);
    unstuff = (d | 0xf) > 0x8f;
  }
  void init_mrp(const uint8_t* data, int lcup, int len2) {
    p = data + lcup + len2 - 1;
    size = len2;
    unstuff = true;
  }
  uint32_t fetch() {
    while (bits < 32) {
      uint64_t d = size > 0 ? *p-- : 0;
      size--;
      push(d);
    }
    return (uint32_t)tmp;
  }
  uint32_t advance(uint32_t n) {
    tmp >>= n;
    bits -= n;
    return (uint32_t)tmp;
  }
};

// a stream read forwards (MagSgn, padded with 0xFF; SigProp, with 0),
// LSB first: a byte after 0xFF gives 7 bits
struct HtFwd {
  const uint8_t* p = nullptr;
  int size = 0;
  uint64_t tmp = 0;
  uint32_t bits = 0;
  bool unstuff = false;
  uint64_t x = 0;
  void init(const uint8_t* data, int n, uint64_t pad) {
    p = data;
    size = n;
    x = pad;
  }
  uint32_t fetch() {
    while (bits < 32) {
      uint64_t d = size > 0 ? *p++ : x;
      size--;
      tmp |= d << bits;
      bits += 8 - (unstuff ? 1 : 0);
      unstuff = (d & 0xff) == 0xff;
    }
    return (uint32_t)tmp;
  }
  void advance(uint32_t n) {
    tmp >>= n;
    bits -= n;
  }
};

// u of a quad pair from the UVLC (opj's decode_init_uvlc /
// decode_noninit_uvlc); returns the bits it takes; u holds u + kappa (1)
uint32_t ht_uvlc(uint32_t vlc, uint32_t mode, bool initial, uint32_t* u) {
  // by the 3 next bits: prefix length | suffix length << 2 | prefix << 5
  static const uint8_t DEC[8] = {
      3 | (5 << 2) | (5 << 5), 1 | (0 << 2) | (1 << 5), 2 | (0 << 2) | (2 << 5),
      1 | (0 << 2) | (1 << 5), 3 | (1 << 2) | (3 << 5), 1 | (0 << 2) | (1 << 5),
      2 | (0 << 2) | (2 << 5), 1 | (0 << 2) | (1 << 5)};
  uint32_t used = 0;
  auto suffix = [&](uint32_t d) {
    uint32_t n = (d >> 2) & 7;
    uint32_t v = (d >> 5) + (vlc & ((1u << n) - 1));
    vlc >>= n;
    used += n;
    return v;
  };
  auto prefix = [&]() {
    uint32_t d = DEC[vlc & 7];
    vlc >>= d & 3;
    used += d & 3;
    return d;
  };
  if (mode == 0) {
    u[0] = u[1] = 1;
  } else if (mode <= 2) {
    uint32_t d = suffix(prefix());
    u[0] = mode == 1 ? d + 1 : 1;
    u[1] = mode == 1 ? 1 : d + 1;
  } else if (mode == 3 && initial) {  // both u_off, the MEL event 0
    uint32_t d1 = prefix();
    if ((d1 & 3) > 2) {
      u[1] = (vlc & 1) + 2;
      vlc >>= 1;
      used++;
      u[0] = suffix(d1) + 1;
    } else {
      uint32_t d2 = prefix();
      u[0] = suffix(d1) + 1;
      u[1] = suffix(d2) + 1;
    }
  } else {  // both u_off: not initial, or initial with the MEL event 1
    uint32_t d1 = prefix();
    uint32_t d2 = prefix();
    uint32_t add = mode == 4 ? 3 : 1;
    u[0] = suffix(d1) + add;
    u[1] = suffix(d2) + add;
  }
  return used;
}

inline uint32_t bitlen32(uint32_t v) { return v ? 32 - (uint32_t)__builtin_clz(v) : 0; }

// decodes an HT code-block into t1.data (w x h, two's complement with one
// fractional bit); fails where OpenJPEG fails
void decode_ht_cblk(T1& t1, Cblk& cb, uint32_t roishift, uint32_t cblksty) {
  const uint32_t w = (uint32_t)(cb.x1 - cb.x0), h = (uint32_t)(cb.y1 - cb.y0);
  t1.w = w;
  t1.h = h;
  t1.data.assign((size_t)w * h, 0);
  if (roishift != 0) fail("We do not support ROI in decoding HT codeblocks");
  if (cb.Mb == 0 || cb.numsegs == 0) return;
  const uint32_t zero_bplanes = cb.Mb + 1 - cb.numbps;
  const uint32_t cblk_len = (uint32_t)cb.data.size();
  uint32_t num_passes = cb.segs[0].numpasses;
  num_passes += cb.numsegs > 1 ? cb.segs[1].numpasses : 0;
  const uint32_t lengths1 = num_passes > 0 ? cb.segs[0].len : 0;
  uint32_t lengths2 = 0;
  if (num_passes > 1) lengths2 = cb.segs.size() > 1 ? cb.segs[1].len : 0;
  if (num_passes > 1 && lengths2 == 0) num_passes = 1;  // a warning
  if (num_passes > 3)
    fail("We do not support more than 3 coding passes in an HT codeblock");
  if (cb.Mb > 30) fail("32 bits are not enough to decode this codeblock");
  if (zero_bplanes > cb.Mb) fail("Malformed HT codeblock (zero bitplanes)");
  if (zero_bplanes == cb.Mb && num_passes > 1) num_passes = 1;  // a warning
  const uint32_t p = cb.numbps;
  const uint32_t zero_bplanes_p1 = zero_bplanes + 1;
  if (lengths1 < 2 || lengths1 > cblk_len || lengths1 + lengths2 > cblk_len)
    fail("Malformed HT codeblock. Invalid codeblock length values.");
  // the code-block's bytes, with room past their end for the readers
  std::vector<uint8_t>& buf = cb.data;
  buf.resize(cblk_len + 8, 0);
  const uint8_t* coded = buf.data();
  const int lcup = (int)lengths1;
  const int scup = ((int)coded[lcup - 1] << 4) + (coded[lcup - 2] & 0xf);
  if (scup < 2 || scup > lcup || scup > 4079)
    fail("Malformed HT codeblock. 2 <= Scup <= min(Lcup, 4079) is not met");
  HtMel mel;
  if (!mel.init(coded, lcup, scup))
    fail("Malformed HT codeblock. Incorrect MEL segment sequence.");
  HtRev vlc;
  vlc.init_vlc(coded, lcup, scup);
  HtFwd magsgn;
  magsgn.init(coded, lcup - scup, 0xff);

  uint32_t* dd = reinterpret_cast<uint32_t*>(t1.data.data());
  std::vector<uint8_t> sig((size_t)w * h, 0);  // significant after cleanup
  // per quad column: bit 7 sigma, bits 0-6 the largest E, of the last row
  // of the quad row above (entry j: columns 2j - 1 and 2j)
  std::vector<uint8_t> line((size_t)w / 2 + 4, 0);
  int run = mel.run();

  auto sample = [&](uint32_t qinf, uint32_t i, uint32_t U, uint32_t* s,
                    uint32_t& vn) {
    uint32_t ms = magsgn.fetch();
    uint32_t m_n = U - ((qinf >> (12 + i)) & 1);
    magsgn.advance(m_n);
    uint32_t val = ms << 31;
    uint32_t v = ms & ((1u << m_n) - 1);
    v |= ((qinf >> (8 + i)) & 1) << m_n;
    v |= 1;
    *s = val | ((v + 2) << (p - 1));
    vn = v;
  };

  for (uint32_t y = 0; y < h; y += 2) {
    const bool initial = y == 0;
    const uint16_t* tbl = initial ? VLC_TBL0 : VLC_TBL1;
    uint8_t* lsp = line.data();
    uint32_t ls0 = lsp[0];
    lsp[0] = 0;
    uint32_t c_q = 0;
    for (uint32_t x = 0; x < w; x += 4) {
      uint32_t qinf[2] = {0, 0};
      uint32_t vlc_val = vlc.fetch();
      for (int q = 0; q < 2; q++) {
        if (q == 1 && x + 2 >= w) break;
        if (!initial) {
          if (q == 0) {
            c_q |= ls0 >> 7;
            c_q |= (lsp[1] >> 5) & 0x4;
          } else {
            c_q |= lsp[1] >> 7;
            c_q |= (lsp[2] >> 5) & 0x4;
          }
        }
        qinf[q] = tbl[(c_q << 7) | (vlc_val & 0x7f)];
        if (c_q == 0) {
          run -= 2;
          qinf[q] = run == -1 ? qinf[q] : 0;
          if (run < 0) run = mel.run();
        }
        if (initial)
          c_q = ((qinf[q] & 0x10) >> 4) | ((qinf[q] & 0xe0) >> 5);
        else
          c_q = ((qinf[q] & 0x40) >> 5) | ((qinf[q] & 0x80) >> 6);
        vlc_val = vlc.advance(qinf[q] & 0x7);
      }
      uint32_t mode = ((qinf[0] & 0x8) >> 3) | ((qinf[1] & 0x8) >> 2);
      if (initial && mode == 3) {
        run -= 2;
        mode += run == -1 ? 1 : 0;
        if (run < 0) run = mel.run();
      }
      uint32_t U[2];
      vlc.advance(ht_uvlc(vlc_val, mode, initial, U));
      if (!initial) {
        // kappa from the largest E above where the quad has 2+ samples
        if ((qinf[0] & 0xf0) & ((qinf[0] & 0xf0) - 1)) {
          uint32_t e = std::max<uint32_t>(ls0 & 0x7f, lsp[1] & 0x7f);
          U[0] += e > 2 ? e - 2 : 0;
        }
        if ((qinf[1] & 0xf0) & ((qinf[1] & 0xf0) - 1)) {
          uint32_t e = std::max<uint32_t>(lsp[1] & 0x7f, lsp[2] & 0x7f);
          U[1] += e > 2 ? e - 2 : 0;
        }
      }
      if (U[0] > zero_bplanes_p1 || U[1] > zero_bplanes_p1)
        fail("Malformed HT codeblock. U_q is larger than zero bitplanes + 1");
      if (!initial) {
        ls0 = lsp[2];
        lsp[1] = lsp[2] = 0;
      }
      uint32_t locs = 0xff;
      if (x + 4 > w) locs >>= (x + 4 - w) << 1;
      if (y + 2 > h) locs &= 0x55;
      if ((((qinf[0] & 0xf0) >> 4) | (qinf[1] & 0xf0)) & ~locs)
        fail("Malformed HT codeblock. VLC code produces significant samples "
             "outside the codeblock area.");
      // samples: quad 0 then quad 1, each (x, y), (x, y+1), (x+1, y),
      // (x+1, y+1)
      for (int q = 0; q < 2; q++) {
        for (uint32_t c = 0; c < 2; c++) {
          uint32_t xx = x + 2 * (uint32_t)q + c;
          for (uint32_t r = 0; r < 2; r++) {
            uint32_t i = 2 * c + r;
            uint32_t bit = 1u << (4 * q + i);
            if (!(locs & bit)) continue;
            size_t at = (size_t)(y + r) * w + xx;
            if (qinf[q] & (0x10u << i)) {
              uint32_t vn;
              sample(qinf[q], i, U[q], &dd[at], vn);
              sig[at] = 1;
              if (r == 1) {
                uint32_t e = bitlen32(vn);
                if (c == 0) {
                  uint32_t t = lsp[0] & 0x7f;
                  lsp[0] = (uint8_t)(0x80 | (t > e ? t : e));
                } else {
                  lsp[1] = (uint8_t)(0x80 | e);
                }
              }
            } else {
              dd[at] = 0;
            }
          }
        }
        lsp++;
      }
    }
  }
  if (num_passes > 1) {
    // SigProp: stripes of 4 rows, in groups of 4 columns; in a group the
    // significance bits of its samples (column by column, row by row),
    // then the sign bits of those that became significant.  A sample is
    // visited where it is not significant and one of its 8 neighbours is
    // (significant after the cleanup, or found so earlier in this pass);
    // with VSC the row below a stripe does not count
    const bool causal = (cblksty & CBLKSTY_VSC) != 0;
    HtFwd sp;
    sp.init(coded + lengths1, (int)lengths2, 0);
    std::vector<uint8_t> st(sig);
    const uint32_t val = 3u << (p - 2);
    auto is_sig = [&](int64_t xx, int64_t yy) {
      return xx >= 0 && yy >= 0 && xx < (int64_t)w && yy < (int64_t)h &&
             st[(size_t)yy * w + (size_t)xx];
    };
    std::vector<size_t> fresh;
    for (uint32_t y0 = 0; y0 < h; y0 += 4) {
      uint32_t y1 = std::min(y0 + 4, h);
      for (uint32_t g = 0; g < w; g += 4) {
        fresh.clear();
        for (uint32_t x = g; x < std::min(g + 4, w); x++)
          for (uint32_t y = y0; y < y1; y++) {
            size_t at = (size_t)y * w + x;
            if (st[at]) continue;
            bool south = !(causal && y == y0 + 3);
            int64_t X = x, Y = y;
            bool any = is_sig(X - 1, Y - 1) || is_sig(X, Y - 1) ||
                       is_sig(X + 1, Y - 1) || is_sig(X - 1, Y) ||
                       is_sig(X + 1, Y) ||
                       (south && (is_sig(X - 1, Y + 1) || is_sig(X, Y + 1) ||
                                  is_sig(X + 1, Y + 1)));
            if (!any) continue;
            uint32_t b = sp.fetch() & 1;
            sp.advance(1);
            if (b) {
              st[at] = 1;
              fresh.push_back(at);
            }
          }
        for (size_t at : fresh) {
          uint32_t s = sp.fetch() & 1;
          sp.advance(1);
          dd[at] = (s << 31) | val;
        }
      }
    }
  }
  if (num_passes > 2) {
    // MagRef: the cleanup's significant samples in the same scan
    HtRev mrp;
    mrp.init_mrp(coded, (int)lengths1, (int)lengths2);
    for (uint32_t y0 = 0; y0 < h; y0 += 4) {
      uint32_t y1 = std::min(y0 + 4, h);
      for (uint32_t x = 0; x < w; x++)
        for (uint32_t y = y0; y < y1; y++) {
          size_t at = (size_t)y * w + x;
          if (!sig[at]) continue;
          uint32_t b = mrp.fetch() & 1;
          mrp.advance(1);
          dd[at] ^= (1u - b) << (p - 1);
          dd[at] |= 1u << (p - 2);
        }
    }
  }
  buf.resize(cblk_len);
  for (size_t i = 0; i < (size_t)w * h; i++) {
    int32_t v = (int32_t)(dd[i] & 0x7fffffff);
    t1.data[i] = (dd[i] & 0x80000000u) ? -v : v;
  }
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

// the inverse DWT of resolutions 1 to `top`
template <typename T, typename F, typename V>
void idwt2d(TileComp& tc, T* data, uint32_t top, F f1d, V vert) {
  size_t w = (size_t)(tc.x1 - tc.x0);
  std::vector<T> tmp;
  for (uint32_t r = 1; r <= top; r++) {
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

  // ---------------------------------------------------------- Part 2
  // OpenJPEG 2.5.3's opj_j2k_read_mct / _mcc / _mco / _cbd: what it does
  // not take in charge it skips with a warning (the marker is then read);
  // MCO zeroes every DC level shift and takes an MCC collection's offset
  // array as the shifts; CBD sets the components' precision and sign.
  // COD's MCT byte 2 (the array transform) is refused by read_cod, so the
  // decorrelation array is only checked, never applied.

  void read_mct(TCP& tcp, const uint8_t* p, uint32_t size) {
    if (size < 2) fail("Error reading MCT marker");
    if (rd(p, 2) != 0) return;  // "mct data within multiple MCT records"
    if (size <= 6) fail("Error reading MCT marker");
    uint32_t t = rd(p, 2);  // Imct
    uint32_t index = t & 0xff;
    size_t i = 0;
    while (i < tcp.mcts.size() && tcp.mcts[i].index != index) i++;
    if (i == tcp.mcts.size()) tcp.mcts.emplace_back();
    MctRecord& r = tcp.mcts[i];
    r.data.clear();
    r.index = index;
    r.element_type = (t >> 10) & 3;
    if (rd(p, 2) != 0) return;  // Ymct: "multiple MCT markers"
    r.data.assign(p, p + (size - 6));
  }

  int find_mct(const TCP& tcp, uint32_t index) {
    for (size_t j = 0; j < tcp.mcts.size(); j++)
      if (tcp.mcts[j].index == index) return (int)j;
    return -1;
  }

  void read_mcc(TCP& tcp, const uint8_t* p, uint32_t size) {
    if (size < 2) fail("Error reading MCC marker");
    if (rd(p, 2) != 0) return;  // Zmcc: "multiple data spanning"
    if (size < 7) fail("Error reading MCC marker");
    uint32_t index = rd(p, 1);
    uint32_t i = 0;
    while (i < tcp.nb_mcc && tcp.mccs[i].index != index) i++;
    bool fresh = i == tcp.nb_mcc;
    if (tcp.mccs.size() <= tcp.nb_mcc) tcp.mccs.resize(tcp.nb_mcc + 1);
    MccRecord& r = tcp.mccs[i];
    r.index = index;
    if (rd(p, 2) != 0) return;  // Ymcc: "multiple data spanning"
    uint32_t ncoll = rd(p, 2);  // Qmcc
    if (ncoll > 1) return;      // "multiple collections"
    size -= 7;
    for (uint32_t c = 0; c < ncoll; c++) {
      if (size < 3) fail("Error reading MCC marker");
      if (rd(p, 1) != 1) return;  // "other than array decorrelation"
      uint32_t n = rd(p, 2);
      size -= 3;
      uint32_t nb = 1 + (n >> 15);
      r.nb_comps = n & 0x7fff;
      if (size < nb * r.nb_comps + 2) fail("Error reading MCC marker");
      size -= nb * r.nb_comps + 2;
      for (uint32_t j = 0; j < r.nb_comps; j++)
        if (rd(p, (int)nb) != j) return;  // "indix shuffle"
      n = rd(p, 2);
      nb = 1 + (n >> 15);
      if ((n & 0x7fff) != r.nb_comps) return;  // "same number of indixes"
      if (size < nb * r.nb_comps + 3) fail("Error reading MCC marker");
      size -= nb * r.nb_comps + 3;
      for (uint32_t j = 0; j < r.nb_comps; j++)
        if (rd(p, (int)nb) != j) return;  // "indix shuffle"
      uint32_t t = rd(p, 3);
      r.deco = r.offset = -1;
      if ((t & 0xff) != 0) {
        r.deco = find_mct(tcp, t & 0xff);
        if (r.deco < 0) fail("Error reading MCC marker");
      }
      if (((t >> 8) & 0xff) != 0) {
        r.offset = find_mct(tcp, (t >> 8) & 0xff);
        if (r.offset < 0) fail("Error reading MCC marker");
      }
    }
    if (size != 0) fail("Error reading MCC marker");
    if (fresh) tcp.nb_mcc++;
  }

  // an MCT record's element k as opj_j2k_read_*_to_int32 reads it (the
  // integers unsigned)
  static int32_t mct_int(const MctRecord& r, size_t k) {
    const uint8_t* q = r.data.data() + k * MCT_ELEMENT_SIZE[r.element_type];
    switch (r.element_type) {
      case 0: return (int32_t)((uint32_t)q[0] << 8 | q[1]);
      case 1: return (int32_t)((uint32_t)q[0] << 24 | (uint32_t)q[1] << 16 |
                               (uint32_t)q[2] << 8 | q[3]);
      case 2: {
        uint32_t b = (uint32_t)q[0] << 24 | (uint32_t)q[1] << 16 |
                     (uint32_t)q[2] << 8 | q[3];
        float f;
        std::memcpy(&f, &b, 4);
        return (int32_t)f;
      }
      default: {
        uint64_t b = 0;
        for (int j = 0; j < 8; j++) b = b << 8 | q[j];
        double f;
        std::memcpy(&f, &b, 8);
        return (int32_t)f;
      }
    }
  }

  // opj_j2k_add_mct, whose search never moves past the first MCC record
  void add_mct(TCP& tcp, uint32_t index) {
    if (tcp.nb_mcc == 0 || tcp.mccs[0].index != index) return;
    const MccRecord& r = tcp.mccs[0];
    uint32_t nc = numcomps();
    if (r.nb_comps != nc) return;
    if (r.deco >= 0) {
      const MctRecord& m = tcp.mcts[(size_t)r.deco];
      if (m.data.size() != (size_t)MCT_ELEMENT_SIZE[m.element_type] * nc * nc)
        fail("MCT decorrelation array of a wrong size");
    }
    if (r.offset >= 0) {
      const MctRecord& m = tcp.mcts[(size_t)r.offset];
      if (m.data.size() != (size_t)MCT_ELEMENT_SIZE[m.element_type] * nc)
        fail("MCT offset array of a wrong size");
      for (uint32_t c = 0; c < nc; c++) tcp.tccps[c].dc_shift = mct_int(m, c);
    }
  }

  void read_mco(TCP& tcp, const uint8_t* p, uint32_t size) {
    if (size < 1) fail("Error reading MCO marker");
    uint32_t nstages = rd(p, 1);
    if (nstages > 1) return;  // "multiple transformation stages"
    if (size != nstages + 1) fail("Error reading MCO marker");
    for (auto& tc : tcp.tccps) tc.dc_shift = 0;
    for (uint32_t i = 0; i < nstages; i++) add_mct(tcp, rd(p, 1));
  }

  void read_cbd(const uint8_t* p, uint32_t size) {
    if (size != numcomps() + 2) fail("Crror reading CBD marker");
    if (rd(p, 2) != numcomps()) fail("Crror reading CBD marker");
    for (auto& c : comps) {
      uint32_t t = rd(p, 1);
      c.sgnd = t >> 7;
      c.prec = (t & 0x7f) + 1;
      if (c.prec > 31) fail("Invalid values for comp: prec");
    }
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
      case 0xff50: break;  // CAP: OpenJPEG reads nothing of it
      case 0xff59: break;  // CPF
      case 0xff74: read_mct(tcp, p, size); break;
      case 0xff75: read_mcc(tcp, p, size); break;
      case 0xff77: read_mco(tcp, p, size); break;
      case 0xff78: read_cbd(p, size); break;
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
    // no HT branch, as in OpenJPEG 2.5.3: an HT code-block's first
    // segment can take 109 passes, so that a pass in a later layer joins
    // the cleanup segment (cv2 then refuses the block, or misreads it)
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
            cb.Mb = (uint32_t)bd.numbps;
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
          const bool ht = (sty & CBLKSTY_HT) != 0;
          do {
            Seg& s = cb.segs[segno];
            // HT: the first segment takes one pass (the cleanup), a later
            // one all that are left
            s.numnewpasses = ht ? (segno == 0 ? 1 : (uint32_t)n)
                                : (uint32_t)std::min<int64_t>(
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
          // OpenJPEG shifts the 32-bit dx and dy left by levelno, which C
          // leaves undefined at 32 levels; cv2's x86-64 build shifts by
          // the count mod 32 (SHL), so 32 levels shift by 0 here.  The
          // 64-bit shifts below are defined and taken whole.
          uint32_t sh = levelno & 31;
          uint32_t ddx = ic.dx << sh, ddy = ic.dy << sh;
          if ((ddx >> sh) != ic.dx || (ddy >> sh) != ic.dy) return;
          uint32_t trx0 = ceildiv(ttx0, ddx);
          uint32_t try0 = ceildiv(tty0, ddy);
          uint32_t trx1 = ceildiv(ttx1, ddx);
          uint32_t try1 = ceildiv(tty1, ddy);
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
          uint32_t prci = (ceildiv(x, ddx) >> re.pdx) - (trx0 >> re.pdx);
          uint32_t prcj = (ceildiv(y, ddy) >> re.pdy) - (try0 >> re.pdy);
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
    // a packet in any tile so far (a POC can leave a component's top
    // resolutions without one): that resolution's samples fill the top
    // left of the tile buffer, whose other samples stay 0
    std::vector<uint32_t> rdec(numcomps());
    for (uint32_t c = 0; c < numcomps(); c++)
      rdec[c] = std::min(comps[c].resno_decoded, tiles[c].numres - 1);
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
              if (cp.cblksty & CBLKSTY_HT) {
                decode_ht_cblk(t1, cb, cp.roishift, cp.cblksty);
              } else if (!decode_cblk(t1, cb, bd.bandno, cp.roishift,
                                      cp.cblksty)) {
                fail("opj_t1_decode_cblk(): unsupported bpno_plus_one");
              }
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
        idwt2d(tc, tc.idata.data(), rdec[c], idwt53, vert53);
      else
        idwt2d(tc, tc.fdata.data(), rdec[c], idwt97, vert97);
    }
    // multiple component transform, on the whole tile buffers
    if (tcp.mct) {
      if (numcomps() >= 3) {
        if (tiles[0].numres != tiles[1].numres ||
            tiles[0].numres != tiles[2].numres)
          fail("Tiles don't all have the same dimension. Skip the MCT step.");
        if (rdec[0] != rdec[1] || rdec[0] != rdec[2])
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
    // DC level shift and clamp on the decoded resolution, and into the
    // image: a lone tile's whole buffer (OpenJPEG hands it over), else the
    // decoded resolution at its place on the reduced grid
    bool lone = tw * th == 1;
    for (uint32_t c = 0; c < numcomps(); c++) {
      TileComp& tc = tiles[c];
      Comp& ic = comps[c];
      const TCCP& cp = tcp.tccps[c];
      const Res& rr = tc.res[rdec[c]];
      int32_t lmin, lmax;
      if (ic.sgnd) {
        lmin = -(int32_t)(1u << (ic.prec - 1));
        lmax = (int32_t)((1u << (ic.prec - 1)) - 1);
      } else {
        lmin = 0;
        lmax = (int32_t)((1u << ic.prec) - 1);
      }
      size_t w = (size_t)(tc.x1 - tc.x0), h = (size_t)(tc.y1 - tc.y0);
      size_t rw = (size_t)(rr.x1 - rr.x0), rh = (size_t)(rr.y1 - rr.y0);
      std::vector<int32_t> out(w * h, 0);
      for (size_t j = 0; j < rh; j++) {
        int32_t* dst = out.data() + j * w;
        if (cp.qmfbid == 1) {
          const int32_t* s = tc.idata.data() + j * w;
          for (size_t i = 0; i < rw; i++) {
            int32_t v = (int32_t)((uint32_t)s[i] + (uint32_t)cp.dc_shift);
            dst[i] = v < lmin ? lmin : v > lmax ? lmax : v;
          }
        } else {
          const float* s = tc.fdata.data() + j * w;
          for (size_t i = 0; i < rw; i++) {
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
      if (lone && (size_t)ic.w == w && (size_t)ic.h == h) {
        ic.data.swap(out);
        continue;
      }
      // opj_j2k_update_image_data: the region [rr.x0, rr.x1) clipped to
      // the component
      int64_t dx0 = ic.x0, dx1 = (int64_t)ic.x0 + ic.w;
      int64_t dy0 = ic.y0, dy1 = (int64_t)ic.y0 + ic.h;
      int64_t cx0 = std::max<int64_t>(rr.x0, dx0), cx1 = std::min<int64_t>(rr.x1, dx1);
      int64_t cy0 = std::max<int64_t>(rr.y0, dy0), cy1 = std::min<int64_t>(rr.y1, dy1);
      for (int64_t y = cy0; y < cy1; y++)
        for (int64_t x = cx0; x < cx1; x++)
          ic.data[(size_t)(y - dy0) * ic.w + (size_t)(x - dx0)] =
              out[(size_t)(y - rr.y0) * w + (size_t)(x - rr.x0)];
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
// cause in `err`; `*code` is 0, or 1 where it is refused.
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

// Flood-fill segmented min-scan sweeps, hand-written for sm_90a.
//
// Replaces: mergenet_tpu/ops/pallas/floodscan.py::flood_scan
//   (_flood_scan_call, the pl.pallas_call at floodscan.py:105).
// Computes, from the row-major iota label grid, `ccl` sweeps of
// stride-sublattice segmented min-scans: horizontal forward + reverse at
// stride s gated by h_links, then vertical forward + reverse at stride t
// gated by v_links.  link[p] != 0 means p and p+stride (along the axis)
// are connected.  Reference: decoder/device.py::_scan_sweeps.
//
// Bound on this card: bytes.  The function reads two (H, W) uint8 link
// planes and writes one (H, W) int32 label plane: 6 bytes per pixel,
// about 3 MB at 512x1024, i.e. ~1 us at 3.35 TB/s; its min/select work
// (ccl * 4 * H * W) is ~100x below the integer rate.  The working set
// (labels + links, ~3 MB) stays in the 50 MB L2 across the 2*ccl passes.
// What a pass costs in practice is instruction issue and latency inside
// each block, most of it in the scans: on the H100 a pass takes 6-7 us
// of device time and the launch gaps in CUDA-graph replay are small
// (PERF.md), so fusing the passes into one launch would gain little.
//
// Design: one launch per axis pass (2*ccl launches; the iota is folded
// into the first pass, which stages each label as its pixel id).  A
// "line" is a row (H pass) or a column (V pass).  A block of 1024
// threads stages whole lines in shared memory with coalesced loads (16
// bytes of labels and 4 of links per thread where the width allows): 4
// rows of up to 2048 pixels, or a strip of 8 adjacent columns (one
// 32-byte sector of labels per row) of up to 1024 rows, so the served
// 512x1024 grid gives 128 blocks per pass.  Each staged word packs the
// label (bits 0-30) with the link bit (bit 31): one shared-memory read
// serves both, and a padding word every 32 positions spreads a warp's
// strided accesses over the banks.  Every stride sublattice of a line
// is a chain, scanned by a group of P lanes (P a power of two, up to
// 1024: 128 lanes of 4 elements at the served shape) with a three-phase
// segmented min-scan:
//   1. each lane scans its contiguous run of the chain (at most 16
//      elements) serially, held in registers and branch-free;
//   2. the lanes' packed (min, segment-start) aggregates combine by a
//      shuffle scan within each warp and, for groups of several warps,
//      through shared memory;
//   3. each lane folds the carry into its run up to the first segment
//      boundary;
// forward and in reverse at once, from the staged values: an element's
// segment minimum is the smaller of the minimum from its segment's
// start and the minimum to its segment's end.  Then the lines are
// written back coalesced.  A line longer than a
// block holds is walked in tiles: a forward sweep over the tiles, then
// a reverse sweep, each tile staged with a halo of the chain neighbours
// just outside it (the previous tile's forward values, the next tile's
// final values) read back from the label plane, so the carry needs no
// state of its own and any H, W and stride work.  A set-min is
// order-free, so the result is bit-exact, and label[p] <= p holds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr uint32_t kLink = 0x80000000u;  // link bit of a staged word
constexpr uint32_t kVal = 0x7fffffffu;   // label bits; kVal: no label

// Lines per block and positions per line held in shared memory, for the
// H pass (kV = false: rows) and the V pass (kV = true: columns).
template <bool kV>
struct Axis {
  static constexpr int kLines = kV ? 8 : 4;
  static constexpr int kCap = kV ? 1024 : 2048;
  static constexpr int kPitch = kCap + kCap / 32 + 1;  // odd: lines skew
};

__device__ __forceinline__ int sidx(int lp) { return lp + (lp >> 5); }

// a / b for a >= 0, b > 0: a shift when b is a power of two (the usual
// strides and chain counts)
__device__ __forceinline__ int udiv(int a, int b) {
  return (b & (b - 1)) == 0 ? a >> (__ffs(b) - 1) : a / b;
}

// The longest run a lane holds in registers.  With kThreads lanes over
// the chains of kLines lines of at most kCap positions, no run is longer
// (every width and stride checked; launch_pass refuses a longer one).
constexpr int kMaxRun = 16;

// Lanes per chain for a pass: enough groups of P lanes for the chains a
// block holds, P a power of two in [1, kThreads].  Sets *max_run to the
// longest run a lane then scans.
template <bool kV>
int lanes_per_chain(int n, int q, int* max_run) {
  const int cap = Axis<kV>::kCap;
  // chains per line and the longest segment (positions) a block stages
  int qe = n <= cap ? q : (q < cap / 2 ? q : cap / 2);
  int nl = n <= cap ? n : cap;
  int chains = Axis<kV>::kLines * (qe < nl ? qe : nl);
  int P = kThreads;
  while (P > 1 && kThreads / P < chains) P >>= 1;
  int max_len = (nl + qe - 1) / qe;
  *max_run = (max_len + P - 1) / P;
  return P;
}

// A segmented min-scan aggregate packs the minimum (bits 0-30) with
// "a segment starts here or later" (bit 31, kLink's bit).  b follows a.
__device__ __forceinline__ uint32_t combine(uint32_t a, uint32_t b) {
  return (b & kLink) ? b : (min(a & kVal, b & kVal) | (a & kLink));
}

// Shared state of the cross-warp combine: one aggregate per warp and
// direction.
struct WarpAggs {
  uint32_t a[2][kThreads / 32];
};

// Phase 2 of a chain's scan: the exclusive segmented scans of the
// lanes' packed aggregates across the group of P lanes (lane j), forward
// (fa) and in reverse (ra) at once; returns the carries into this
// lane's run in fa and ra (kVal: none).  A group of more than 32 lanes
// spans whole warps, whose aggregates combine through shared memory
// (one barrier for both directions).
__device__ __forceinline__ void group_carry(uint32_t& fa, uint32_t& ra,
                                            int j, int P, WarpAggs& wa) {
  const int width = P < 32 ? P : 32;
  const int wl = threadIdx.x & (width - 1);  // lane in the warp's group
  for (int d = 1; d < width; d <<= 1) {
    uint32_t of = __shfl_up_sync(0xffffffffu, fa, d, width);
    uint32_t orv = __shfl_down_sync(0xffffffffu, ra, d, width);
    if (wl >= d) fa = combine(of, fa);
    if (wl + d < width) ra = combine(orv, ra);
  }
  uint32_t cf = __shfl_up_sync(0xffffffffu, fa, 1, width);
  uint32_t cr = __shfl_down_sync(0xffffffffu, ra, 1, width);
  if (wl == 0) cf = kVal;
  if (wl == width - 1) cr = kVal;
  if (P > 32) {  // the carries of the group's other warps, in scan order
    const int warp = threadIdx.x >> 5, nw = P >> 5;
    const int wg = j >> 5, w0 = warp - wg;
    if (wl == 31) wa.a[0][warp] = fa;
    if (wl == 0) wa.a[1][warp] = ra;
    __syncthreads();
    uint32_t c = kVal;
    for (int w = 0; w < wg; ++w) c = combine(c, wa.a[0][w0 + w]);
    cf = combine(c, cf);
    c = kVal;
    for (int w = nw - 1; w > wg; --w) c = combine(c, wa.a[1][w0 + w]);
    cr = combine(c, cr);
  }
  fa = cf & kVal;
  ra = cr & kVal;
}

// One chain of a staged line, scanned by a group of P lanes (lane j of
// the group), each lane holding a run of at most kRun elements in
// registers: one load of the run, the scans, one store.  `s` is the
// line's staged words, element k at local position r + k * qe; `len`
// elements.  `active` is false for groups without a chain this round:
// they take part in the shuffles and barriers only.  Branch-free over
// the run: every lane loads kRun words (positions past its run clamp to
// its last element) and selects.
//   1. the lane scans its run serially, forward and in reverse, from
//      the staged values;
//   2. group_carry combines the lanes' aggregates, both directions at
//      once;
//   3. each direction's carry reaches the run's elements before its
//      first segment boundary.
// With fwd and rev, an element's segment minimum is the smaller of its
// forward value (the minimum from the segment's start) and its reverse
// value (the minimum to the segment's end).  With one of them, the
// element gets that direction's value: the tiles of a long line scan
// forward, store, then scan those values in reverse.
template <int kRun>
__device__ void scan_chain(uint32_t* __restrict__ s, int r, int qe, int len,
                           int j, int P, int logP, bool active, bool fwd,
                           bool rev, WarpAggs& wa) {
  const int run = (len + P - 1) >> logP;
  const int lo = min(j * run, len);
  const int cnt = active ? min(lo + run, len) - lo : 0;
  const int last = max(lo + cnt - 1, 0);
  uint32_t w[kRun], f[kRun];
#pragma unroll
  for (int i = 0; i < kRun; ++i) w[i] = s[sidx(r + min(lo + i, last) * qe)];
  // the link into the run's first element, in forward order
  const bool link_in =
      (s[sidx(r + max(lo - 1, 0) * qe)] & kLink) && lo > 0 && cnt > 0;
  // phase 1, forward: f[i] = the minimum from the segment's start
  // within the run; facc | fbrk = the run's forward aggregate
  uint32_t facc = kVal, fbrk = 0;
  bool prev = link_in;
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    bool in = i < cnt;
    bool st = lo + i == 0 || !prev;
    uint32_t a = st ? (w[i] & kVal) : min(facc, w[i] & kVal);
    facc = in ? a : facc;
    fbrk |= in && st ? kLink : 0u;
    prev = w[i] & kLink;
    f[i] = a;
  }
  // phase 1, reverse: w[i]'s value bits become the minimum to the
  // segment's end within the run
  uint32_t racc = kVal, rbrk = 0;
#pragma unroll
  for (int i = kRun - 1; i >= 0; --i) {
    bool in = i < cnt;
    bool en = lo + i == len - 1 || !(w[i] & kLink);
    uint32_t a = en ? (w[i] & kVal) : min(racc, w[i] & kVal);
    racc = in ? a : racc;
    rbrk |= in && en ? kLink : 0u;
    w[i] = (w[i] & kLink) | a;
  }
  uint32_t cf = facc | fbrk, cr = racc | rbrk;
  group_carry(cf, cr, j, P, wa);
  // phase 3: each carry up to the run's first boundary in its direction
  bool go = cf != kVal;
  prev = link_in;
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    go = go && lo + i != 0 && prev;
    prev = w[i] & kLink;
    f[i] = go ? min(f[i], cf) : f[i];
  }
  go = cr != kVal;
#pragma unroll
  for (int i = kRun - 1; i >= 0; --i) {  // slots past the run: skipped
    go = i < cnt ? go && lo + i != len - 1 && (w[i] & kLink) : go;
    uint32_t v = go ? min(w[i] & kVal, cr) : (w[i] & kVal);
    v = fwd && rev ? min(v, f[i]) : (fwd ? f[i] : v);
    w[i] = (w[i] & kLink) | v;
  }
  // past-the-run slots alias the run's last element: store them first,
  // so that its own value lands last
  if (cnt > 0) {
#pragma unroll
    for (int i = kRun - 1; i >= 0; --i)
      s[sidx(r + min(lo + i, last) * qe)] = w[i];
  }
}

// A staged segment of every line of the block: `nl` local positions,
// chains at local stride `qe`; local position lp holds line position
// g(lp) = lp < cut ? lp + off0 : lp + off1 (outside [0, n): no pixel).
// The positions lp in [st0, st1) are the tile that is written back.
struct Seg {
  int nl, qe, cut, off0, off1, st0, st1;
  __device__ int g(int lp) const { return lp < cut ? lp + off0 : lp + off1; }
};

template <bool kV>
__device__ void scan_all(uint32_t* sm, const Seg& sg, int nlines_blk,
                         bool fwd, bool rev, int P, WarpAggs& wa) {
  const int logP = __ffs(P) - 1;
  const int j = threadIdx.x & (P - 1), group = threadIdx.x >> logP;
  const int groups = kThreads >> logP;
  const int nr = min(sg.qe, sg.nl);  // chains per line
  const int nch = nlines_blk * nr;
  // the longest chain's run picks, for the whole block, how many
  // registers a lane's run takes (4, 8 or kMaxRun)
  const int max_run = (udiv(sg.nl + sg.qe - 1, sg.qe) + P - 1) >> logP;
  for (int base = 0; base < nch; base += groups) {
    int c = base + group;
    bool active = c < nch;
    int l = active ? udiv(c, nr) : 0, r = active ? c - l * nr : 0;
    int len = active ? udiv(sg.nl - r + sg.qe - 1, sg.qe) : 0;
    uint32_t* s = sm + l * Axis<kV>::kPitch;
    if (max_run <= 4)
      scan_chain<4>(s, r, sg.qe, len, j, P, logP, active, fwd, rev, wa);
    else if (max_run <= 8)
      scan_chain<8>(s, r, sg.qe, len, j, P, logP, active, fwd, rev, wa);
    else
      scan_chain<kMaxRun>(s, r, sg.qe, len, j, P, logP, active, fwd, rev,
                          wa);
    if (P > 32) __syncthreads();  // the aggregates are read
  }
}

// Global element index of (line, line position).
template <bool kV>
__device__ __forceinline__ int64_t gaddr(int line, int pos, int W) {
  return kV ? (int64_t)pos * W + line : (int64_t)line * W + pos;
}

// Stage a segment: label (or, with `iota`, the pixel id on the tile
// part) and link bit of every local position of every line.
template <bool kV>
__device__ void stage(uint32_t* sm, const int32_t* label,
                      const uint8_t* __restrict__ link, const Seg& sg,
                      int line0, int nlines_blk, int n, int q, int W,
                      bool iota) {
  const int total = nlines_blk * sg.nl;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    int l = kV ? e % nlines_blk : e / sg.nl;
    int lp = kV ? e / nlines_blk : e % sg.nl;
    int p = sg.g(lp);
    uint32_t w = kVal;
    if (p >= 0 && p < n) {
      int64_t a = gaddr<kV>(line0 + l, p, W);
      bool tile = lp >= sg.st0 && lp < sg.st1;
      w = iota && tile ? (uint32_t)a : (uint32_t)label[a];
      if (p + q < n && link[a]) w |= kLink;
    }
    sm[l * Axis<kV>::kPitch + sidx(lp)] = w;
  }
}

template <bool kV>
__device__ void store(uint32_t* sm, int32_t* label,
                      const Seg& sg, int line0, int nlines_blk, int n,
                      int W) {
  const int span = sg.st1 - sg.st0;
  const int total = nlines_blk * span;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    int l = kV ? e % nlines_blk : e / span;
    int lp = sg.st0 + (kV ? e / nlines_blk : e % span);
    int p = sg.g(lp);
    if (p >= 0 && p < n)
      label[gaddr<kV>(line0 + l, p, W)] =
          (int32_t)(sm[l * Axis<kV>::kPitch + sidx(lp)] & kVal);
  }
}

// The whole-line fast path with 16-byte label and 4-byte link accesses:
// a full block of lines whose quads are aligned (checked by the host).
template <bool kV>
__device__ __forceinline__ void quad_at(int e, int n, int& l, int& p) {
  // H: line l, positions p..p+3.  V: position p, lines l..l+3.
  constexpr int L = Axis<kV>::kLines;
  if (kV) {
    p = e / (L / 4);
    l = 4 * (e % (L / 4));
  } else {
    l = e / (n / 4);
    p = 4 * (e % (n / 4));
  }
}

template <bool kV>
__device__ void stage_vec(uint32_t* sm, const int32_t* label,
                          const uint8_t* __restrict__ link, int line0,
                          int n, int q, int W, bool iota) {
  constexpr int L = Axis<kV>::kLines;
  const int quads = kV ? n * (L / 4) : L * (n / 4);
  for (int e = threadIdx.x; e < quads; e += kThreads) {
    int l, p;
    quad_at<kV>(e, n, l, p);
    int64_t a = gaddr<kV>(line0 + l, p, W);
    int4 v = iota ? make_int4((int)a, (int)a + 1, (int)a + 2, (int)a + 3)
                  : *reinterpret_cast<const int4*>(label + a);
    uchar4 k = *reinterpret_cast<const uchar4*>(link + a);
    int vv[4] = {v.x, v.y, v.z, v.w};
    unsigned char kk[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int li = kV ? l + i : l, pi = kV ? p : p + i;
      uint32_t w = (uint32_t)vv[i];
      if (pi + q < n && kk[i]) w |= kLink;
      sm[li * Axis<kV>::kPitch + sidx(pi)] = w;
    }
  }
}

template <bool kV>
__device__ void store_vec(uint32_t* sm, int32_t* label,
                          int line0, int n, int W) {
  constexpr int L = Axis<kV>::kLines;
  const int quads = kV ? n * (L / 4) : L * (n / 4);
  for (int e = threadIdx.x; e < quads; e += kThreads) {
    int l, p;
    quad_at<kV>(e, n, l, p);
    int vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int li = kV ? l + i : l, pi = kV ? p : p + i;
      vv[i] = (int)(sm[li * Axis<kV>::kPitch + sidx(pi)] & kVal);
    }
    *reinterpret_cast<int4*>(label + gaddr<kV>(line0 + l, p, W)) =
        make_int4(vv[0], vv[1], vv[2], vv[3]);
  }
}

// One axis pass over every line: H pass (kV = false) at stride q over
// rows gated by `link`, or V pass (kV = true) over columns.  `iota`:
// the labels start as pixel ids (the first pass).  `vec`: the host
// found the planes' rows 16-byte (labels) and 4-byte (links) aligned.
// The label plane is read and written by one block (the long-line
// tiles read back their neighbours' stores), so it is neither const nor
// __restrict__: no read may take the non-coherent path.
template <bool kV>
__global__ void __launch_bounds__(kThreads)
scan_pass(int32_t* label, const uint8_t* __restrict__ link, int H, int W,
          int q, int iota, int vec, int P) {
  using A = Axis<kV>;
  __shared__ uint32_t sm[A::kLines * A::kPitch];
  __shared__ WarpAggs wa;
  const int nlines = kV ? W : H, n = kV ? H : W;
  const int line0 = blockIdx.x * A::kLines;
  const int nlb = min(A::kLines, nlines - line0);
  if (n <= A::kCap) {  // whole lines: stage, forward + reverse, store
    Seg sg{n, q, n, 0, 0, 0, n};
    bool v4 = vec && nlb == A::kLines;
    if (v4)
      stage_vec<kV>(sm, label, link, line0, n, q, W, iota);
    else
      stage<kV>(sm, label, link, sg, line0, nlb, n, q, W, iota);
    __syncthreads();
    scan_all<kV>(sm, sg, nlb, true, true, P, wa);
    __syncthreads();
    if (v4)
      store_vec<kV>(sm, label, line0, n, W);
    else
      store<kV>(sm, label, sg, line0, nlb, n, W);
    return;
  }
  // long lines: tiles of TL positions, each staged with a halo of hs
  // chain neighbours; hs = min(q, TL), so local stride hs links a
  // position with its halo neighbour as global stride q does
  const int hs = min(q, A::kCap / 2);
  const int TL = A::kCap - hs;
  const int nt = (n + TL - 1) / TL;
  for (int t = 0; t < nt; ++t) {  // forward: halo = the previous tile's
    int T0 = t * TL, tl = min(TL, n - T0);
    Seg sg{hs + tl, hs, hs, T0 - q, T0 - hs, hs, hs + tl};
    stage<kV>(sm, label, link, sg, line0, nlb, n, q, W, iota);
    __syncthreads();
    scan_all<kV>(sm, sg, nlb, true, false, P, wa);
    __syncthreads();
    store<kV>(sm, label, sg, line0, nlb, n, W);
    __syncthreads();  // the stores are the next tile's halo
  }
  for (int t = nt - 1; t >= 0; --t) {  // reverse: halo = the next tile's
    int T0 = t * TL, tl = min(TL, n - T0);
    Seg sg{tl + hs, hs, tl, T0, T0 + q - hs, 0, tl};
    stage<kV>(sm, label, link, sg, line0, nlb, n, q, W, false);
    __syncthreads();
    scan_all<kV>(sm, sg, nlb, false, true, P, wa);
    __syncthreads();
    store<kV>(sm, label, sg, line0, nlb, n, W);
    __syncthreads();
  }
}

__global__ void iota_kernel(int32_t* __restrict__ label, int64_t n) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i < n) label[i] = (int32_t)i;
}

template <bool kV>
cudaError_t launch_pass(int32_t* lab, const uint8_t* link, int H, int W,
                        int q, int iota, cudaStream_t st) {
  int nlines = kV ? W : H, n = kV ? H : W;
  bool aligned = W % 4 == 0 && (uintptr_t)lab % 16 == 0 &&
                 (uintptr_t)link % 4 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((nlines + Axis<kV>::kLines - 1) /
                                Axis<kV>::kLines));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  int max_run;
  int P = lanes_per_chain<kV>(n, q, &max_run);
  if (max_run > kMaxRun) return cudaErrorInvalidConfiguration;
  return cudaLaunchKernelEx(&cfg, scan_pass<kV>, lab, link, H, W, q, iota,
                            (int)aligned, P);
}

}  // namespace

extern "C" int mn_flood_scan(void* label, const void* h_links,
                             const void* v_links, int H, int W, int s, int t,
                             int ccl, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* lab = (int32_t*)label;
  if (H <= 0 || W <= 0) return 0;
  cudaError_t err = cudaSuccess;
  bool iota = true;
  for (int sweep = 0; sweep < ccl; ++sweep) {
    if (h_links) {
      err = launch_pass<false>(lab, (const uint8_t*)h_links, H, W, s, iota,
                               st);
      if (err != cudaSuccess) return (int)err;
      iota = false;
    }
    if (v_links) {
      err = launch_pass<true>(lab, (const uint8_t*)v_links, H, W, t, iota,
                              st);
      if (err != cudaSuccess) return (int)err;
      iota = false;
    }
  }
  if (iota) {  // no pass ran: the labels stay the pixel ids
    int64_t n = (int64_t)H * W;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)((n + 255) / 256));
    cfg.blockDim = dim3(256);
    cfg.stream = st;
    err = cudaLaunchKernelEx(&cfg, iota_kernel, lab, n);
  }
  return (int)err;
}

extern "C" const char* mn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Best absorption edge per pixel, hand-written for sm_90a.
//
// Replaces: mergenet_tpu/ops/pallas/absorb.py::absorb_best_edges
//   (the pl.pallas_call at absorb.py:153).
// For every pixel p, over every offset o and both directions (the edge
// p -> p+o with evidence log_odds[o][p], and the edge p-o -> p with
// evidence log_odds[o][p-o]), the lexicographically largest
// (priority, partner) candidate, where priority is the edge's log-odds
// when the edge is eligible and NEG_INF otherwise.  Eligible: partner in
// range and in another component, same argmax class, min(size) <=
// size_cap, log-odds >= theta, neither side frozen, and the hook goes
// UP in (size, id) order.  Ties break to the larger partner.  Stats come
// per pixel either packed as size<<5 | argcls<<1 | frozen (C <= 16, the
// layout of the TPU kernel), or unpacked as two planes, argcls<<1 |
// frozen and size (C > 16, where the reference runs its XLA loop).
// Reference: the jnp loop of decoder/device.py::decode_hierarchical
// stage 2.
//
// Bound on this card: at most it reads comp (4 B), stats (4 B) and O
// log-odds planes (4*O B) per pixel and writes pri and partner (8 B):
// 56 B per pixel at O = 10, ~29 MB at 512x1024, ~9 us at 3.35 TB/s.  A
// log-odds value matters only to an edge that passes the other tests, so
// the bytes a given input needs are fewer (chip_smoke.py counts them),
// and the compare/select work (~20 integer instructions per candidate,
// 2*O candidates per pixel) bounds it instead.
//
// Design: one thread per pixel, blocks of 16x32 pixels, three blocks per
// SM; column tiles on the grid's x, row tiles on y and, past 65535 of
// them, on z (any H and W).  comp and stats are staged
// once into shared memory (cp.async) over the tile plus a halo that
// covers every "short" offset (|di| <= 16, |dj| <= 32; sized to the
// short offsets given), so a neighbour word moves from L2 once per tile
// and not once per offset; a long offset's neighbour is read from global
// memory (L2).  A candidate both of whose sides are over the size cap,
// or whose own side is frozen, can only be (NEG_INF, partner): when
// every lane of a warp has such a candidate the warp skips the evidence
// read and the compare/select work and folds the partner into a running
// max of its own, merged at the end; otherwise it reads the evidence
// (global, L1-cached) and evaluates the candidate in full.  Words outside
// the image are staged or read as sentinels (comp -1, stats frozen with
// the largest size), which make a candidate (NEG_INF, -1), exactly the
// reference's out-of-range fill, so the scan has few bounds tests.  An
// offset with |di| >= H or |dj| >= W has no in-image candidate and is
// skipped.  Any O <= 64 (kMaxOffsets), any offset magnitude.  The
// designs tried against this one, and their times, are in PERF.md
// section 6.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdlib.h>

namespace {

constexpr int kMaxOffsets = 64;
constexpr float kNegInf = -3.0e38f;
constexpr int kTW = 32, kTH = 16;            // tile: one pixel per thread
constexpr int kThreads = kTW * kTH;
constexpr int kBlocksPerSM = 3;
constexpr int kHaloRowsMax = 16;             // "short" offsets: |di| <= 16
constexpr int kHaloColsMax = 32;             //                  |dj| <= 32
constexpr uint32_t kCompFill = 0xffffffffu;  // comp -1
// stats outside the image: frozen, and (packed) the largest size, so the
// size test alone rules their candidates out
constexpr uint32_t kStatFill = 0x7fffffe1u;
constexpr uint32_t kSizeFill = 0x7fffffffu;  // unpacked size plane

struct Params {
  int H, W;
  float theta;
  int size_cap;
  int vec;        // 16-byte halo copies
  int hr, hc;     // halo rows and columns (hc a multiple of 4)
  int n;          // offsets kept, in order
  int plane[kMaxOffsets];  // each kept offset's log-odds plane
  int di[kMaxOffsets], dj[kMaxOffsets];
  int in_halo[kMaxOffsets];  // |di| <= hr and |dj| <= hc
  int capw;       // (size_cap + 1) << 5, clamped: a packed stats word
                  // at or over it is over the size cap, or frozen
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(uint32_t* dst,
                                          const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(uint32_t* dst,
                                           const uint32_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
}

// Rows [gi0, gi0 + rows) x columns [gj0, gj0 + cols) of an (H, W) plane
// into dst (row pitch `cols` words); words outside the image get `fill`.
// With `vec`, gj0 and cols are multiples of 4 and dst is 16-byte aligned.
__device__ void stage(uint32_t* dst, const uint32_t* plane, int gi0,
                      int gj0, int rows, int cols, int H, int W,
                      uint32_t fill, bool vec) {
  if (vec) {
    const int chunks = cols >> 2, n = rows * chunks;
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const int r = t / chunks, c = (t - r * chunks) << 2;
      const int gi = gi0 + r, gj = gj0 + c;
      uint32_t* d = dst + r * cols + c;
      if (gi >= 0 && gi < H && gj >= 0 && gj + 4 <= W) {
        cp_async16(d, plane + (int64_t)gi * W + gj);
      } else {  // W % 4 == 0: the chunk lies wholly outside
        d[0] = d[1] = d[2] = d[3] = fill;
      }
    }
  } else {
    const int n = rows * cols;
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const int r = t / cols, c = t - r * cols;
      const int gi = gi0 + r, gj = gj0 + c;
      if (gi >= 0 && gi < H && gj >= 0 && gj < W)
        cp_async4(dst + t, plane + (int64_t)gi * W + gj);
      else
        dst[t] = fill;
    }
  }
}

// The running lexicographic max over (priority, partner), branch-free.
__device__ __forceinline__ void consider(float p, int q, float& bp,
                                         int& bq) {
  const bool take = (p > bp) | ((p == bp) & (q > bq));
  bp = take ? p : bp;
  bq = take ? q : bq;
}

// A pixel's own side: comp c, cf = argcls<<1 | frozen, size, and the
// tests that depend on it alone.
struct Own {
  int c, cf, sz;
  bool fwd_ok;  // not frozen
  bool bwd_ok;  // not frozen, c >= 0
  bool small;   // sz <= size_cap
};

// A neighbour: comp n, cf, size (sentinels outside the image).
struct Nbr {
  int n, cf, sz;
};

// Forward edge p -> p + o to neighbour q, evidence l = log_odds[o][p].
__device__ __forceinline__ void forward(const Own& o, const Nbr& q,
                                        float l, float theta, int cap,
                                        float& bp, int& bq) {
  const bool ok = o.fwd_ok & (q.n >= 0) & (q.n != o.c) & (q.cf == o.cf) &
                  (o.small | (q.sz <= cap)) & (l >= theta);
  const bool up = (q.sz > o.sz) | ((q.sz == o.sz) & (q.n > o.c));
  consider(ok & up ? l : kNegInf, q.n, bp, bq);
}

// Backward edge p - o -> p, seen from q = p - o with evidence
// l = log_odds[o][p - o]: eligible when the hook there goes DOWN (so
// p's side goes up).
__device__ __forceinline__ void backward(const Own& o, const Nbr& q,
                                         float l, float theta, int cap,
                                         float& bp, int& bq) {
  const bool ok = o.bwd_ok & (q.n != o.c) & (q.cf == o.cf) &
                  (o.small | (q.sz <= cap)) & (l >= theta);
  const bool up = (o.sz > q.sz) | ((o.sz == q.sz) & (o.c > q.n));
  consider(ok & !up ? l : kNegInf, q.n, bp, bq);
}

// The staged or global planes of a pixel's comp and stats.
template <bool kPacked>
__device__ __forceinline__ Nbr nbr(uint32_t n, uint32_t st, uint32_t sz) {
  if (kPacked) return Nbr{(int)n, (int)(st & 31u), (int)st >> 5};
  return Nbr{(int)n, (int)st, (int)sz};
}


// Raw comp, stats (and size) words of q = p + e: staged, or from L2 with
// the sentinels outside the image.
template <bool kPacked>
__device__ __forceinline__ void fetch_raw(bool staged, const uint32_t* hcomp,
                                          const uint32_t* hstat,
                                          const uint32_t* hsize, int w,
                                          const uint32_t* comp,
                                          const uint32_t* stat,
                                          const uint32_t* size, int i, int j,
                                          int H, int W, uint32_t& n,
                                          uint32_t& st, uint32_t& sz) {
  if (staged) {
    n = hcomp[w];
    st = hstat[w];
    sz = kPacked ? 0u : hsize[w];
  } else if ((unsigned)i >= (unsigned)H || (unsigned)j >= (unsigned)W) {
    n = kCompFill;
    st = kStatFill;
    sz = kSizeFill;
  } else {
    const int64_t q = (int64_t)i * W + j;
    n = __ldg(comp + q);
    st = __ldg(stat + q);
    sz = kPacked ? 0u : __ldg(size + q);
  }
}

template <bool kPacked>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    absorb_tiles(const uint32_t* __restrict__ comp,
                 const uint32_t* __restrict__ stat,
                 const uint32_t* __restrict__ size,
                 const float* __restrict__ log_odds,
                 float* __restrict__ best_pri,
                 int32_t* __restrict__ best_partner,
                 const __grid_constant__ Params P) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int H = P.H, W = P.W;
  // row tiles past the y dimension's 65535 continue along z
  const int ti = blockIdx.z * gridDim.y + blockIdx.y;
  if (ti > (H - 1) / kTH) return;  // the last z slice's spare blocks
  const int i0 = ti * kTH, j0 = blockIdx.x * kTW;
  const int hr = P.hr, hc = P.hc;
  const int HP = kTW + 2 * hc;           // halo pitch
  const int HW = (kTH + 2 * hr) * HP;    // halo words per plane
  uint32_t* const hcomp = smem;
  uint32_t* const hstat = smem + HW;
  uint32_t* const hsize = smem + 2 * HW;  // unpacked only
  const bool vec = P.vec != 0;
  stage(hcomp, comp, i0 - hr, j0 - hc, kTH + 2 * hr, HP, H, W, kCompFill,
        vec);
  stage(hstat, stat, i0 - hr, j0 - hc, kTH + 2 * hr, HP, H, W, kStatFill,
        vec);
  if (!kPacked)
    stage(hsize, size, i0 - hr, j0 - hc, kTH + 2 * hr, HP, H, W,
          kSizeFill, vec);
  cp_async_wait_all();
  __syncthreads();

  const int ty = threadIdx.x / kTW, tx = threadIdx.x % kTW;
  const int i = i0 + ty, j = j0 + tx;
  const int h = (ty + hr) * HP + tx + hc;  // own halo word
  const float theta = P.theta;
  const int cap = P.size_cap;
  const Nbr me = nbr<kPacked>(hcomp[h], hstat[h], kPacked ? 0 : hsize[h]);
  const Own own{me.n, me.cf, me.sz, (me.cf & 1) == 0,
                (me.cf & 1) == 0 && me.n >= 0, me.sz <= cap};
  float bp = kNegInf;
  int bq = -1, aq = -1;  // aq: the largest partner of a skipped candidate
  for (int s = 0; s < P.n; ++s) {
    const int di = P.di[s], dj = P.dj[s];
    const float* lo = log_odds + P.plane[s] * (int64_t)H * W;
#pragma unroll
    for (int bwd = 0; bwd < 2; ++bwd) {
      const int ei = bwd ? -di : di, ej = bwd ? -dj : dj;  // q = p + e
      uint32_t qn, qs, qz;
      fetch_raw<kPacked>(P.in_halo[s], hcomp, hstat, hsize, h + ei * HP + ej,
                         comp, stat, size, i + ei, j + ej, H, W, qn, qs, qz);
      // open: the candidate may be eligible; a warp with no open lane
      // only folds the partners into aq
      const bool nsmall = kPacked ? (int)qs < P.capw : (int)qz <= cap;
      const bool open = (bwd ? own.bwd_ok : own.fwd_ok) & (own.small | nsmall);
      if (__any_sync(0xffffffffu, open)) {
        const Nbr q = nbr<kPacked>(qn, qs, qz);
        // the evidence lies at p (forward) or at q (backward)
        const int li = bwd ? i + ei : i, lj = bwd ? j + ej : j;
        const float l =
            (unsigned)li < (unsigned)H && (unsigned)lj < (unsigned)W
                ? __ldg(lo + (int64_t)li * W + lj)
                : 0.f;
        if (bwd)
          backward(own, q, l, theta, cap, bp, bq);
        else
          forward(own, q, l, theta, cap, bp, bq);
      } else {
        aq = max(aq, (int)qn);
      }
    }
  }
  consider(kNegInf, aq, bp, bq);
  if (i < H && j < W) {
    best_pri[(int64_t)i * W + j] = bp;
    best_partner[(int64_t)i * W + j] = bq;
  }
}

int aligned16(const void* a) { return (uintptr_t)a % 16 == 0; }

// Shared memory at the largest halo: 16 + 2*16 rows of 32 + 2*32 words
// per staged plane.
template <bool kPacked>
constexpr int kSmemMaxBytes = 4 * (kPacked ? 2 : 3) *
                              (kTH + 2 * kHaloRowsMax) *
                              (kTW + 2 * kHaloColsMax);

// Dynamic shared memory past the 48 KB default needs the function's
// attribute raised: once per device (bit `dev` of `done`), at the
// largest halo's size, and not on every launch.
template <bool kPacked>
cudaError_t allow_smem(int64_t smem) {
  static unsigned long long done = 0;
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (__atomic_load_n(&done, __ATOMIC_ACQUIRE) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(absorb_tiles<kPacked>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMaxBytes<kPacked>);
  if (err == cudaSuccess) __atomic_fetch_or(&done, bit, __ATOMIC_RELEASE);
  return err;
}

template <bool kPacked>
int launch(const void* comp, const void* stat, const void* size,
           const void* log_odds, void* best_pri, void* best_partner, int H,
           int W, const void* offsets, int num_offsets, float theta,
           int size_cap, void* stream) {
  constexpr int kPlanes = kPacked ? 2 : 3;
  if (num_offsets < 0 || num_offsets > kMaxOffsets || H <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  const int tiles_h = (H - 1) / kTH + 1;
  const int slices = (tiles_h - 1) / 65535 + 1;
  const dim3 grid((W - 1) / kTW + 1, (tiles_h - 1) / slices + 1, slices);
  Params p;
  p.H = H;
  p.W = W;
  p.theta = theta;
  p.size_cap = size_cap;
  const int64_t capw = ((int64_t)size_cap + 1) * 32;
  p.capw = (int)(capw > INT32_MAX ? INT32_MAX
                 : capw < INT32_MIN ? INT32_MIN : capw);
  const int* o = (const int*)offsets;
  int hr = 0, hc = 0, n = 0;
  for (int k = 0; k < num_offsets; ++k) {
    const int64_t adi = llabs((int64_t)o[2 * k]);
    const int64_t adj = llabs((int64_t)o[2 * k + 1]);
    if (adi >= H || adj >= W) continue;  // no in-image candidate
    p.plane[n] = k;
    p.di[n] = o[2 * k];
    p.dj[n] = o[2 * k + 1];
    p.in_halo[n] = adi <= kHaloRowsMax && adj <= kHaloColsMax;
    if (p.in_halo[n++]) {
      hr = adi > hr ? (int)adi : hr;
      hc = adj > hc ? (int)adj : hc;
    }
  }
  p.n = n;
  p.hr = hr;
  p.hc = (hc + 3) & ~3;
  const int64_t smem =
      4 * (int64_t)kPlanes * (kTH + 2 * p.hr) * (kTW + 2 * p.hc);
  p.vec = W % 4 == 0 && aligned16(comp) && aligned16(stat) &&
          (kPacked || aligned16(size));
  cudaError_t err = allow_smem<kPacked>(smem);
  if (err != cudaSuccess) return (int)err;
  absorb_tiles<kPacked><<<grid, kThreads, (size_t)smem,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)comp, (const uint32_t*)stat, (const uint32_t*)size,
      (const float*)log_odds, (float*)best_pri, (int32_t*)best_partner, p);
  return (int)cudaGetLastError();
}

}  // namespace

// Packed stats: packed[p] = size<<5 | argcls<<1 | frozen.
extern "C" int mn_absorb_best_edges(const void* comp, const void* packed,
                                    const void* log_odds, void* best_pri,
                                    void* best_partner, int H, int W,
                                    const void* offsets, int num_offsets,
                                    float theta, int size_cap,
                                    void* stream) {
  return launch<true>(comp, packed, nullptr, log_odds, best_pri,
                                 best_partner, H, W, offsets, num_offsets,
                                 theta, size_cap, stream);
}

// Unpacked stats: clsfz[p] = argcls<<1 | frozen, size[p] unclamped.
extern "C" int mn_absorb_best_edges_unpacked(
    const void* comp, const void* clsfz, const void* size,
    const void* log_odds, void* best_pri, void* best_partner, int H, int W,
    const void* offsets, int num_offsets, float theta, int size_cap,
    void* stream) {
  return launch<false>(comp, clsfz, size, log_odds, best_pri,
                                    best_partner, H, W, offsets,
                                    num_offsets, theta, size_cap, stream);
}

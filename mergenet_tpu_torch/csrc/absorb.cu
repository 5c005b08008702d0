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
// packed per pixel as size<<5 | argcls<<1 | frozen.  Reference: the jnp
// loop of decoder/device.py::decode_hierarchical stage 2.
//
// Bound on this card: bytes.  Inputs comp (4 B), packed (4 B) and O
// log-odds planes (4*O B) per pixel, outputs pri (4 B) and partner
// (4 B): 56 B per pixel at O = 10, ~29 MB at 512x1024, ~9 us at
// 3.35 TB/s.  The compare/select work is a few hundred integer and
// float operations per pixel, under the memory time.
//
// Design: one thread per pixel, a loop over the offsets in the
// reference's order (forward candidate, then backward), neighbours read
// with bounds-checked global loads.  The neighbour reads hit the same
// planes again at other offsets; at 512x1024 those planes (~29 MB) fit
// the 50 MB L2, so the re-reads cost L2, not HBM, bandwidth.  Any H, W.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxOffsets = 64;
constexpr float kNegInf = -3.0e38f;

struct Offsets {
  int n;
  int di[kMaxOffsets];
  int dj[kMaxOffsets];
};

__device__ __forceinline__ void consider(float p, int q, float& bp,
                                         int& bq) {
  if (p > bp || (p == bp && q > bq)) {
    bp = p;
    bq = q;
  }
}

__global__ void absorb_kernel(const int32_t* __restrict__ comp,
                              const int32_t* __restrict__ packed,
                              const float* __restrict__ log_odds,
                              float* __restrict__ best_pri,
                              int32_t* __restrict__ best_partner, int H,
                              int W, Offsets offs, float theta,
                              int size_cap) {
  int64_t n = (int64_t)H * W;
  int64_t p = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (p >= n) return;
  int i = (int)(p / W), j = (int)(p % W);
  int c = comp[p];
  int pk = packed[p];
  int size_own = pk >> 5, arg_own = (pk >> 1) & 15;
  bool froz_own = (pk & 1) != 0;
  float bp = kNegInf;
  int bq = -1;
  for (int o = 0; o < offs.n; ++o) {
    const int di = offs.di[o], dj = offs.dj[o];
    const float* lo = log_odds + (int64_t)o * n;
    // forward edge p -> p + o, evidence lo[p]
    float pf = kNegInf;
    int qf = -1;
    int i2 = i + di, j2 = j + dj;
    if (i2 >= 0 && i2 < H && j2 >= 0 && j2 < W) {
      int64_t p2 = (int64_t)i2 * W + j2;
      int nbr = comp[p2];
      int pn = packed[p2];
      int size_n = pn >> 5, arg_n = (pn >> 1) & 15;
      bool froz_n = (pn & 1) != 0;
      float oml = lo[p];
      bool ok = nbr >= 0 && nbr != c && arg_n == arg_own &&
                min(size_own, size_n) <= size_cap && oml >= theta &&
                !froz_own && !froz_n;
      bool up = size_n > size_own || (size_n == size_own && nbr > c);
      qf = nbr;
      pf = (ok && up) ? oml : kNegInf;
    }
    consider(pf, qf, bp, bq);
    // backward edge p - o -> p, evidence lo[p - o]; eligible from that
    // pixel's side when the hook there goes DOWN (so p's side goes up)
    float pb = kNegInf;
    int qb = -1;
    int i3 = i - di, j3 = j - dj;
    if (i3 >= 0 && i3 < H && j3 >= 0 && j3 < W) {
      int64_t p3 = (int64_t)i3 * W + j3;
      int c3 = comp[p3];
      int p3k = packed[p3];
      int size3 = p3k >> 5, arg3 = (p3k >> 1) & 15;
      bool froz3 = (p3k & 1) != 0;
      float oml3 = lo[p3];
      bool ok = c >= 0 && c != c3 && arg_own == arg3 &&
                min(size3, size_own) <= size_cap && oml3 >= theta &&
                !froz3 && !froz_own;
      bool up3 = size_own > size3 || (size_own == size3 && c > c3);
      qb = c3;
      pb = (ok && !up3) ? oml3 : kNegInf;
    }
    consider(pb, qb, bp, bq);
  }
  best_pri[p] = bp;
  best_partner[p] = bq;
}

}  // namespace

extern "C" int mn_absorb_best_edges(const void* comp, const void* packed,
                                    const void* log_odds, void* best_pri,
                                    void* best_partner, int H, int W,
                                    const void* offsets, int num_offsets,
                                    float theta, int size_cap,
                                    void* stream) {
  if (num_offsets < 0 || num_offsets > kMaxOffsets)
    return (int)cudaErrorInvalidValue;
  Offsets offs;
  offs.n = num_offsets;
  const int* o = (const int*)offsets;
  for (int k = 0; k < num_offsets; ++k) {
    offs.di[k] = o[2 * k];
    offs.dj[k] = o[2 * k + 1];
  }
  int64_t n = (int64_t)H * W;
  absorb_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                  (cudaStream_t)stream>>>(
      (const int32_t*)comp, (const int32_t*)packed,
      (const float*)log_odds, (float*)best_pri, (int32_t*)best_partner, H,
      W, offs, theta, size_cap);
  return (int)cudaGetLastError();
}

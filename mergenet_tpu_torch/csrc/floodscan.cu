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
//
// Design: every stride sublattice of a row (H pass) or column (V pass)
// is an independent chain.  One warp scans one chain in tiles of 32
// elements: a (value, segment-start flag) Hillis-Steele scan over warp
// shuffles, with the running minimum carried from tile to tile, first
// forward and then in reverse over the forward results.  No shared
// memory and no size limit: any H and W.  A set-min is order-free, so
// the result is bit-exact.  One launch per axis pass (2*ccl launches
// plus the iota fill), all from one C call on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void iota_kernel(int32_t* __restrict__ label, int64_t n) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i < n) label[i] = (int32_t)i;
}

// Inclusive segmented min over one 32-element tile held one per lane.
// `f` marks a lane whose element starts a segment (not linked to the
// previous element in scan order).
__device__ __forceinline__ int tile_scan(int v, bool f, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int ov = __shfl_up_sync(kFull, v, d);
    int of = __shfl_up_sync(kFull, (int)f, d);
    if (lane >= d) {
      if (!f) v = min(v, ov);
      f = f || of;
    }
  }
  return v;
}

// One warp scans the chain base + k*step, k in [0, len), in place.
// link[base + k*step] links element k to element k+1.
__device__ void scan_chain(int32_t* __restrict__ label,
                           const uint8_t* __restrict__ link, int64_t base,
                           int64_t step, int len, int lane) {
  int carry = INT_MAX;
  for (int t0 = 0; t0 < len; t0 += 32) {  // forward
    int k = t0 + lane;
    int v = INT_MAX;
    bool f = true;
    int64_t a = base + (int64_t)k * step;
    if (k < len) {
      v = label[a];
      f = (k == 0) || !link[a - step];
    }
    if (lane == 0 && !f) {  // linked to the previous tile's last element
      v = min(v, carry);
      f = true;
    }
    v = tile_scan(v, f, lane);
    if (k < len) label[a] = v;
    carry = __shfl_sync(kFull, v, 31);
  }
  __syncwarp();
  carry = INT_MAX;
  for (int t0 = 0; t0 < len; t0 += 32) {  // reverse
    int q = t0 + lane;
    int v = INT_MAX;
    bool f = true;
    int64_t a = base + (int64_t)(len - 1 - q) * step;
    if (q < len) {
      v = label[a];
      f = (q == 0) || !link[a];
    }
    if (lane == 0 && !f) {
      v = min(v, carry);
      f = true;
    }
    v = tile_scan(v, f, lane);
    if (q < len) label[a] = v;
    carry = __shfl_sync(kFull, v, 31);
  }
}

// horizontal: chain c = (row i, residue r < s), elements i*W + r + k*s
__global__ void h_pass(int32_t* __restrict__ label,
                       const uint8_t* __restrict__ link, int H, int W,
                       int s) {
  int64_t c = blockIdx.x * (int64_t)kWarpsPerBlock + threadIdx.x / 32;
  if (c >= (int64_t)H * s) return;
  int i = (int)(c / s), r = (int)(c % s);
  int len = (W - r + s - 1) / s;
  scan_chain(label, link, (int64_t)i * W + r, s, len, threadIdx.x % 32);
}

// vertical: chain c = (residue r < t, column j), elements (r + k*t)*W + j
__global__ void v_pass(int32_t* __restrict__ label,
                       const uint8_t* __restrict__ link, int H, int W,
                       int t) {
  int64_t c = blockIdx.x * (int64_t)kWarpsPerBlock + threadIdx.x / 32;
  if (c >= (int64_t)t * W) return;
  int r = (int)(c / W), j = (int)(c % W);
  int len = (H - r + t - 1) / t;
  scan_chain(label, link, (int64_t)r * W + j, (int64_t)t * W, len,
             threadIdx.x % 32);
}

}  // namespace

extern "C" int mn_flood_scan(void* label, const void* h_links,
                             const void* v_links, int H, int W, int s, int t,
                             int ccl, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* lab = (int32_t*)label;
  int64_t n = (int64_t)H * W;
  iota_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(lab, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 32 * kWarpsPerBlock;
  for (int sweep = 0; sweep < ccl; ++sweep) {
    if (h_links) {
      int64_t chains = (int64_t)H * s;
      h_pass<<<(unsigned)((chains + kWarpsPerBlock - 1) / kWarpsPerBlock),
               threads, 0, st>>>(lab, (const uint8_t*)h_links, H, W, s);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    if (v_links) {
      int64_t chains = (int64_t)t * W;
      v_pass<<<(unsigned)((chains + kWarpsPerBlock - 1) / kWarpsPerBlock),
               threads, 0, st>>>(lab, (const uint8_t*)v_links, H, W, t);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

extern "C" const char* mn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared-memory table lookup out[n] = table[idx[n]], hand-written for
// sm_90a.
//
// Replaces: scripts/bench_pallas_gather.py::pallas_gather (the
//   pl.pallas_call at bench_pallas_gather.py:38), the TPU prototype that
//   keeps the whole table resident in on-chip memory (VMEM), replicated
//   across the 128 lanes, and looks each index up with take_along_axis.
// Contract: int32 table (M,), M > 0; int32 indices (N,) meant to lie in
//   [0, M).  An index outside that range is clamped into it (never read
//   out of bounds); the plain version (ops/pgather.py::pgather_plain)
//   clamps the same way.
//
// Bound on this card: bytes.  It reads N indices and writes N values
// (4 bytes each), plus the table once: 4.2 MB + 4*M bytes at N = 524288,
// ~1.3 us at 3.35 TB/s.
//
// Design: the TPU idea kept — the table lives in fast on-chip memory and
// every lookup is served from there.  Each block stages the table in
// dynamic shared memory (above 48 KB only after the opt-in
// cudaFuncAttributeMaxDynamicSharedMemorySize) and then looks up a tile
// of ITEMS * blockDim indices held in registers.  A table larger than
// the 227 KB a block may use (M = 65536 is 256 KB) streams through
// shared memory in equal chunks: after each chunk lands, every thread
// takes the values whose indices fall inside it.  The table is re-read
// from L2 by every block (it is at most a few hundred KB), so device
// memory sees it about once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;  // indices per thread: a tile of 2048 per block

__global__ void __launch_bounds__(kThreads)
pgather_kernel(const int32_t* __restrict__ table,
               const int32_t* __restrict__ idx, int32_t* __restrict__ out,
               int64_t n, int32_t m, int32_t chunk) {
  extern __shared__ int32_t stab[];
  const int64_t tile = (int64_t)kThreads * kItems;
  for (int64_t base = (int64_t)blockIdx.x * tile; base < n;
       base += (int64_t)gridDim.x * tile) {
    int32_t my_idx[kItems];
    int32_t my_val[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      int64_t p = base + (int64_t)k * kThreads + threadIdx.x;
      int32_t i = p < n ? idx[p] : 0;
      my_idx[k] = min(max(i, 0), m - 1);  // the contract's clamp
      my_val[k] = 0;
    }
    for (int32_t c0 = 0; c0 < m; c0 += chunk) {
      int32_t len = min(chunk, m - c0);
      __syncthreads();  // the previous chunk's readers are done
      for (int32_t j = threadIdx.x; j < len; j += kThreads)
        stab[j] = __ldg(table + c0 + j);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        int32_t r = my_idx[k] - c0;
        if (r >= 0 && r < len) my_val[k] = stab[r];
      }
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      int64_t p = base + (int64_t)k * kThreads + threadIdx.x;
      if (p < n) out[p] = my_val[k];
    }
  }
}

int g_smem_optin = -1;   // the device's per-block opt-in limit, bytes
int g_smem_set = 0;      // dynamic smem the kernel is currently allowed

// Entries of one shared-memory chunk for a table of m entries: the
// whole table when it fits, else equal chunks that do.
int pgather_chunk(int m) {
  if (g_smem_optin < 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&g_smem_optin,
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  int cap = g_smem_optin / 4;
  if (cap <= 0) return 0;
  int nchunks = (m + cap - 1) / cap;
  return (m + nchunks - 1) / nchunks;
}

}  // namespace

extern "C" int mn_pgather(const void* table, const void* idx, void* out,
                          int n, int m, void* stream) {
  if (n <= 0) return 0;
  int chunk = pgather_chunk(m);
  if (chunk <= 0) return (int)cudaErrorInvalidValue;
  int smem = chunk * 4;
  if (smem > 48 * 1024 && smem > g_smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        pgather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    g_smem_set = smem;
  }
  int64_t tile = (int64_t)kThreads * kItems;
  int64_t blocks = ((int64_t)n + tile - 1) / tile;
  if (blocks > 65535) blocks = 65535;
  pgather_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)table, (const int32_t*)idx, (int32_t*)out, n, m,
      chunk);
  return (int)cudaGetLastError();
}

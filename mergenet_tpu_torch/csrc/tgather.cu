// Table gather out[n] = table[idx[n]], hand-written for sm_90a.
//
// Replaces: mergenet_tpu/ops/pallas/tgather.py::table_gather
//   (the pl.pallas_call at tgather.py:83).
// int32 table of any size M > 0; indices wrap once when negative
// (i + M) and then clamp into [0, M) — what jnp's table[idx] computes
// and the TPU kernel reproduces.  (Plain PyTorch indexing would raise,
// or device-assert, on such indices instead.)
//
// Bound on this card: bytes.  It reads N int32 indices and writes N
// int32 values, plus the table once: 4.2 MB + 4*M bytes at N = 524288,
// ~1.3 us at 3.35 TB/s.
//
// Design: one thread per index (grid-stride), coalesced index loads and
// stores, the table read through the read-only cache (__ldg) with no
// size limit — the TPU kernel's VMEM residency bound does not apply;
// tables up to a few MB stay in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void tgather_kernel(const int32_t* __restrict__ table,
                               const int32_t* __restrict__ idx,
                               int32_t* __restrict__ out, int64_t n,
                               int32_t m) {
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t k = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; k < n;
       k += stride) {
    int32_t i = idx[k];
    if (i < 0) i += m;
    i = min(max(i, 0), m - 1);
    out[k] = __ldg(table + i);
  }
}

}  // namespace

extern "C" int mn_table_gather(const void* table, const void* idx, void* out,
                               int n, int m, void* stream) {
  if (n <= 0) return 0;
  int64_t blocks = ((int64_t)n + 255) / 256;
  if (blocks > 65535 * 16) blocks = 65535 * 16;
  tgather_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)table, (const int32_t*)idx, (int32_t*)out, n, m);
  return (int)cudaGetLastError();
}

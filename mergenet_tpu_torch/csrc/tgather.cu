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
// ~1.3 us at 3.35 TB/s.  What costs more on random indices is the
// table reads: each lookup moves a whole 32-byte sector from L2, 16.8 MB
// at N = 524288.  On the decoder's own indices (component ids, constant
// along runs of a row) a warp's lookups share sectors and the load
// coalesces them.
//
// Design: each thread reads one int4 quad of indices, wraps and clamps
// them and reads the four entries with __ldg, then stores the four
// results as one int4, so a thread keeps four lookups in flight; a scalar
// tail (and unaligned pointers) take one index per thread.  The table is
// not staged: it is served from L2 and each SM's L1.  1024-thread blocks
// keep the grid, and its launch floor, small.  The design it was timed
// against is in PERF.md section 6.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ int32_t wrap_clamp(int32_t i, int32_t m) {
  if (i < 0) i += m;
  return min(max(i, 0), m - 1);
}

// `vec`: idx and out are 16-byte aligned.
__global__ void __launch_bounds__(kThreads)
tgather_kernel(const int32_t* __restrict__ table,
               const int32_t* __restrict__ idx, int32_t* __restrict__ out,
               int64_t n, int32_t m, int vec) {
  const int64_t nq = vec ? n / 4 : 0;
  const int64_t gtid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t gstride = (int64_t)gridDim.x * kThreads;
  for (int64_t q = gtid; q < nq; q += gstride) {
    int4 v = __ldg(reinterpret_cast<const int4*>(idx) + q);
    reinterpret_cast<int4*>(out)[q] = make_int4(
        __ldg(table + wrap_clamp(v.x, m)), __ldg(table + wrap_clamp(v.y, m)),
        __ldg(table + wrap_clamp(v.z, m)), __ldg(table + wrap_clamp(v.w, m)));
  }
  for (int64_t p = 4 * nq + gtid; p < n; p += gstride)
    out[p] = __ldg(table + wrap_clamp(__ldg(idx + p), m));
}

int aligned16(const void* a) { return (uintptr_t)a % 16 == 0; }

}  // namespace

extern "C" int mn_table_gather(const void* table, const void* idx, void* out,
                               int n, int m, void* stream) {
  if (n <= 0) return 0;
  if (m <= 0) return (int)cudaErrorInvalidValue;
  int vec = aligned16(idx) && aligned16(out);
  int64_t work = vec ? ((int64_t)n + 3) / 4 : n;  // thread iterations
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 65535 * 16) blocks = 65535 * 16;
  tgather_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)table, (const int32_t*)idx, (int32_t*)out, n, m, vec);
  return (int)cudaGetLastError();
}

// On-chip table lookup out[n] = table[idx[n]], hand-written for sm_90a.
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
// ~1.3 us at 3.35 TB/s.  What costs more is moving table entries on
// chip: staging the whole table in shared memory per block of indices
// moves (N / tile) * 4M bytes from L2 (64 MB at M = 65536 in the
// earlier design), and each random 4-byte read from L2 moves a 32-byte
// sector.
//
// Design: the table stays in on-chip memory, as on the TPU; on Hopper
// that is the 50 MB L2 (and each SM's L1), with no staging at all.
// Each thread reads one int4 quad of indices, clamps them and reads the
// four entries with __ldg, then stores the four results as one int4; a
// scalar tail (and unaligned pointers) take one index per thread.  A
// persistent design that stages the table once per thread block cluster
// in distributed shared memory was built and timed against this one on
// the card and lost at M = 8192 and 65536 (PERF.md): staging moves C
// slices per cluster and a partner's entry is a slow remote read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ int32_t clampi(int32_t i, int32_t m) {
  return min(max(i, 0), m - 1);
}

// `vec`: table, idx and out are 16-byte aligned.
__global__ void __launch_bounds__(kThreads)
pgather_l2(const int32_t* __restrict__ table,
           const int32_t* __restrict__ idx, int32_t* __restrict__ out,
           int64_t n, int32_t m, int vec) {
  const int64_t nq = vec ? n / 4 : 0;
  const int64_t gtid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t gstride = (int64_t)gridDim.x * kThreads;
  for (int64_t q = gtid; q < nq; q += gstride) {
    int4 v = __ldg(reinterpret_cast<const int4*>(idx) + q);
    reinterpret_cast<int4*>(out)[q] = make_int4(
        __ldg(table + clampi(v.x, m)), __ldg(table + clampi(v.y, m)),
        __ldg(table + clampi(v.z, m)), __ldg(table + clampi(v.w, m)));
  }
  for (int64_t p = 4 * nq + gtid; p < n; p += gstride)
    out[p] = __ldg(table + clampi(__ldg(idx + p), m));
}

int aligned16(const void* a) { return (uintptr_t)a % 16 == 0; }

}  // namespace

// out[i] = table[clamp(idx[i], 0, m - 1)] for i < n.
extern "C" int mn_pgather(const void* table, const void* idx, void* out,
                          int n, int m, void* stream) {
  if (n <= 0) return 0;
  if (m <= 0) return (int)cudaErrorInvalidValue;
  int vec = aligned16(table) && aligned16(idx) && aligned16(out);
  int64_t work = vec ? ((int64_t)n + 3) / 4 : n;  // thread iterations
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 65535 * 16) blocks = 65535 * 16;
  pgather_l2<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)table, (const int32_t*)idx, (int32_t*)out, n, m, vec);
  return (int)cudaGetLastError();
}

// Launch floor of a gather's grid, for mergenet_tpu_torch/compare_kernels.py:
// an empty kernel of a given grid, and an int4 copy of the indices (the
// gather without its table reads).  Not a kernel of the port.
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void empty_kernel() {}
__global__ void copy_kernel(const int4* __restrict__ a, int4* __restrict__ b,
                            int64_t nq) {
  for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; q < nq;
       q += (int64_t)gridDim.x * blockDim.x)
    b[q] = __ldg(a + q);
}
extern "C" int mn_floor_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
extern "C" int mn_floor_copy(const void* a, void* b, int n, int threads,
                             void* stream) {
  int64_t nq = n / 4;
  copy_kernel<<<(unsigned)((nq + threads - 1) / threads), threads, 0,
                (cudaStream_t)stream>>>((const int4*)a, (int4*)b, nq);
  return (int)cudaGetLastError();
}

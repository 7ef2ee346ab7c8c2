// How bulk copies (cp.async.bulk, global to shared memory, completed on an
// mbarrier) behave on a Hopper card when one thread issues several: the
// cycles the issuing thread spends on them, the cycles until all landed,
// and the bytes a cycle, by copy size and count, for one block alone and
// with a block on each of 132 SMs. csrc/ffn_ln.cu's wide kernel sizes its
// copies from these numbers.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o probe_bulk_copy scripts/probe_bulk_copy.cu
//   ./probe_bulk_copy
//
// Each configuration runs three times from the same source (the second and
// third read L2); the last run's block 0 is printed.
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
__device__ __forceinline__ uint32_t s32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }
__global__ void k(const uint8_t* src, int tile, int ntiles, int nbar, long long* out) {
  extern __shared__ __align__(1024) uint8_t sm[];
  __shared__ __align__(8) uint64_t bars[64];
  if (threadIdx.x == 0) {
    for (int i = 0; i < nbar; ++i) asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(s32(&bars[i])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long t0 = clock64();
    for (int j = 0; j < ntiles; ++j) {
      uint32_t bar = s32(&bars[j % nbar]);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(bar), "r"(tile) : "memory");
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                   :: "r"(s32(sm) + (j % nbar) * tile), "l"(src + (size_t)(blockIdx.x * ntiles + j) * tile), "r"(tile), "r"(bar) : "memory");
    }
    long long t1 = clock64();
    for (int i = 0; i < nbar; ++i) {
      uint32_t bar = s32(&bars[i]);
      for (;;) { uint32_t d; asm volatile("{.reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0; selp.u32 %0,1,0,p;}" : "=r"(d) : "r"(bar) : "memory"); if (d) break; }
    }
    long long t2 = clock64();
    if (blockIdx.x == 0) { out[0] = t1 - t0; out[1] = t2 - t0; }
  }
}
int main() {
  uint8_t* src; long long* out; cudaMalloc(&src, 256 << 20); cudaMalloc(&out, 64);
  cudaMemset(src, 1, 256 << 20);
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
  int sizes[] = {4096, 8192, 16384, 32768, 65536, 131072};
  for (int blocks : {1, 132}) for (int s : sizes) for (int n : {1, 4, 16}) {
    int total = s * n; if (total > 196608) continue;
    for (int rep = 0; rep < 3; ++rep) {  // the second and third from L2
      k<<<blocks, 32, 200 * 1024>>>(src, s, n, n, out);
      cudaDeviceSynchronize();
    }
    long long h[2]; cudaMemcpy(h, out, 16, cudaMemcpyDeviceToHost);
    printf("blocks %3d tile %6d x %2d: issue %6lld cycles, all landed %6lld cycles, %.1f B/cycle\n", blocks, s, n, h[0], h[1], (double)total / h[1]);
  }
  printf("err %s\n", cudaGetErrorString(cudaGetLastError()));
}

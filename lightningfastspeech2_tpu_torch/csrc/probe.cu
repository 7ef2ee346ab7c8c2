// probe: y = 2 * x, the launch check that runs before any other kernel.
//
// Replaces the TPU backend probe in lightningfastspeech2_tpu/ops/
// kernel_gate.py (_probe: a Pallas x * 2 on an (8, 128) f32 tile). Bound:
// launch latency; it moves 8 KB, so one block of 256 threads walks the
// 1024 elements. Its only job is to fail loudly when the build, the load
// or the launch is broken.
#include "common.cuh"

__global__ void probe_kernel(const float* __restrict__ x, float* __restrict__ y, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) y[i] = 2.0f * x[i];
}

LFS2_DEFINE_ERROR_STRING

LFS2_EXPORT int lfs2_probe(const float* x, float* y, int n, void* stream) {
  probe_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, y, n);
  return static_cast<int>(cudaGetLastError());
}

// Shared helpers for the port's CUDA kernels (built for sm_90a).
//
// Each kernel source is compiled on its own into a shared library with a
// plain C interface (kernels/build.py) and called through ctypes. A
// launcher returns the cudaError_t of cudaGetLastError() right after the
// launch; the Python wrapper raises when it is not cudaSuccess.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lfs2 {

// working-dtype codes passed from Python
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch and XLA
}

// round a float to the working dtype's precision and back
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// Load N consecutive elements starting at p (aligned to N * sizeof(T)
// whenever N is a power of two that the vector types cover) as floats.
template <int N> __device__ __forceinline__ void load_vec(const float* p, float* d) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      d[i] = v.x; d[i + 1] = v.y; d[i + 2] = v.z; d[i + 3] = v.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + i);
      d[i] = v.x; d[i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = p[i];
  }
}

template <int N> __device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* d) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + i);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        d[i + 2 * j] = f.x; d[i + 2 * j + 1] = f.y;
      }
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
      d[i] = f.x; d[i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = __bfloat162float(p[i]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- stateless dropout hashes, bit for bit the JAX package's --------------
// The finalizer both hashes share (all arithmetic mod 2^32).
__device__ __forceinline__ unsigned fmix(unsigned x) {
  x ^= x >> 16;
  x *= 2246822519u;
  x ^= x >> 13;
  x *= 3266489917u;
  x ^= x >> 16;
  return x;
}

// per-item seed of the FFN masks: seed + b * 2654435761 (pallas_ffn.py _seed_u32)
__device__ __forceinline__ unsigned item_seed(int seed, int b) {
  return static_cast<unsigned>(seed) + static_cast<unsigned>(b) * 2654435761u;
}

// pallas_ffn.py _pos_keep: global row g (negative rows wrap to uint32),
// column c, per-item seed, salt; keep when the hash is >= threshold
__device__ __forceinline__ bool ffn_keep(int g, int c, unsigned seed_b, unsigned salt,
                                         unsigned threshold) {
  unsigned x = (static_cast<unsigned>(g) * 2654435761u) ^
               (static_cast<unsigned>(c) + 0x9E3779B9u * salt);
  return fmix(x + seed_b) >= threshold;
}

// pallas_attention.py _dropout_keep: global query row r, key column c,
// seed_bh = seed + b * H + h (an int32 sum read as uint32)
__device__ __forceinline__ bool attn_keep(int r, int c, unsigned seed_bh, unsigned threshold) {
  unsigned x = (static_cast<unsigned>(r) * 2654435761u) ^ (static_cast<unsigned>(c) * 1013904223u);
  return fmix(x + seed_bh) >= threshold;
}

// opt a kernel into more than 48 KB of dynamic shared memory
template <typename K> inline cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace lfs2

#define LFS2_EXPORT extern "C" __attribute__((visibility("default")))

// every library exports its own error-string lookup for the wrapper
#define LFS2_DEFINE_ERROR_STRING                                   \
  LFS2_EXPORT const char* lfs2_error_string(int code) {            \
    return cudaGetErrorString(static_cast<cudaError_t>(code));     \
  }

// length_regulator: expand phone rows to frames by duration (forward) and
// sum frame gradients back onto their phones (backward).
//
// Replaces lightningfastspeech2_tpu/ops/pallas_length_regulator.py
// regulate_pallas: _expand_kernel (:30) and _grad_kernel (:66). On the TPU
// both are one-hot matmuls on the MXU, (T_tile x P) x (P x H) per 256-frame
// tile, run at HIGHEST precision in f32 so that the selection stays exact.
// Here the forward is a plain row copy, exact in any dtype, and the
// one-hot trick is not ported.
//
// expand: frame t of item b copies phone idx = min(#{ends <= t}, P - 1)
// (a binary search over the item's running duration sums, kept in shared
// memory), zero for t >= total. One warp per frame, 16-byte copies where
// the row allows them. Bound: bytes, x read and the frames written once.
//
// segment-sum: dx[b, p] = sum of g[b, t] over the frames phone p owns in
// [0, min(total, T)): each phone sums its own contiguous run, so the result
// is deterministic and needs no atomics. One block per (phone, item), a
// thread per column, f32 accumulation rounded once to the output dtype (the
// TPU kernel adds per-tile partials in the gradient's dtype). Bound: bytes,
// g read and dx written once.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kExpandThreads = 256;
constexpr int kFramesPerBlock = 32;

// ---------------------------------------------------------------- expand
template <typename V>
__global__ void __launch_bounds__(kExpandThreads)
regulate_expand_kernel(const V* __restrict__ x, const int* __restrict__ ends, V* __restrict__ out,
                       int P, int T, int row_vecs) {
  extern __shared__ int s_ends[];
  const int b = blockIdx.y;
  for (int p = threadIdx.x; p < P; p += blockDim.x) s_ends[p] = ends[static_cast<size_t>(b) * P + p];
  __syncthreads();
  const int total = s_ends[P - 1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t_end = min(T, (blockIdx.x + 1) * kFramesPerBlock);
  for (int t = blockIdx.x * kFramesPerBlock + warp; t < t_end; t += kExpandThreads / 32) {
    V* dst = out + (static_cast<size_t>(b) * T + t) * row_vecs;
    if (t >= total) {
      for (int c = lane; c < row_vecs; c += 32) dst[c] = V{};
      continue;
    }
    // #{ends <= t}: the first p with ends[p] > t
    int lo = 0, hi = P;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (s_ends[mid] <= t) lo = mid + 1; else hi = mid;
    }
    const V* src = x + (static_cast<size_t>(b) * P + min(lo, P - 1)) * row_vecs;
    for (int c = lane; c < row_vecs; c += 32) dst[c] = src[c];
  }
}

// ----------------------------------------------------------- segment-sum
template <typename T>
__global__ void regulate_segsum_kernel(const T* __restrict__ g, const int* __restrict__ ends,
                                       T* __restrict__ dx, int P, int Tf, int H) {
  const int p = blockIdx.x, b = blockIdx.y;
  const int* e = ends + static_cast<size_t>(b) * P;
  const int start = min(p == 0 ? 0 : e[p - 1], Tf);
  const int stop = min(e[p], Tf);  // ends[p] <= total, so frames past it are not summed
  const T* gb = g + static_cast<size_t>(b) * Tf * H;
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    float acc = 0.0f;
    for (int t = start; t < stop; ++t) acc += lfs2::to_f(gb[static_cast<size_t>(t) * H + h]);
    dx[(static_cast<size_t>(b) * P + p) * H + h] = lfs2::from_f<T>(acc);
  }
}

template <typename V>
cudaError_t launch_expand(const void* x, const int* ends, void* out, int B, int P, int T,
                          int row_bytes, cudaStream_t stream) {
  const dim3 grid((T + kFramesPerBlock - 1) / kFramesPerBlock, B);
  const int smem = P * static_cast<int>(sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t err = lfs2::allow_smem(regulate_expand_kernel<V>, smem);
    if (err != cudaSuccess) return err;
  }
  regulate_expand_kernel<V><<<grid, kExpandThreads, smem, stream>>>(
      static_cast<const V*>(x), ends, static_cast<V*>(out), P, T,
      row_bytes / static_cast<int>(sizeof(V)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_segsum(const void* g, const int* ends, void* dx, int B, int P, int Tf, int H,
                          cudaStream_t stream) {
  const int threads = min(256, (H + 31) / 32 * 32);
  regulate_segsum_kernel<T><<<dim3(P, B), threads, 0, stream>>>(
      static_cast<const T*>(g), ends, static_cast<T*>(dx), P, Tf, H);
  return cudaGetLastError();
}

}  // namespace

LFS2_DEFINE_ERROR_STRING

// x (B, P, H) -> out (B, T, H); ends (B, P) int32 running duration sums;
// elem_bytes the element size (the copy is dtype-blind)
LFS2_EXPORT int lfs2_regulate_fwd(const void* x, const int* ends, void* out, int B, int P, int T,
                                  int H, int elem_bytes, void* stream) {
  const int row_bytes = H * elem_bytes;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the widest copy unit that every row start of both tensors is aligned to
  const auto aligned = [&](int n) {
    return row_bytes % n == 0 && reinterpret_cast<uintptr_t>(x) % n == 0 &&
           reinterpret_cast<uintptr_t>(out) % n == 0;
  };
  if (aligned(16)) return static_cast<int>(launch_expand<uint4>(x, ends, out, B, P, T, row_bytes, s));
  if (aligned(4)) return static_cast<int>(launch_expand<unsigned>(x, ends, out, B, P, T, row_bytes, s));
  if (aligned(2)) return static_cast<int>(launch_expand<unsigned short>(x, ends, out, B, P, T, row_bytes, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// g (B, T, H) -> dx (B, P, H) in the same dtype (lfs2::DType code)
LFS2_EXPORT int lfs2_regulate_bwd(const void* g, const int* ends, void* dx, int B, int P, int T,
                                  int H, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfs2::kF32) return static_cast<int>(launch_segsum<float>(g, ends, dx, B, P, T, H, s));
  if (dtype == lfs2::kBF16) return static_cast<int>(launch_segsum<__nv_bfloat16>(g, ends, dx, B, P, T, H, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

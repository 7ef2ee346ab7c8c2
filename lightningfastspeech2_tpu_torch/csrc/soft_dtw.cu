// soft_dtw: exact soft-DTW over a batch of (N, M) distance lattices, forward
// (the R lattice and its corner value) and backward (the E-recurrence,
// giving dValue/dD).
//
// Replaces lightningfastspeech2_tpu/ops/pallas_soft_dtw.py
// soft_dtw_from_dist_pallas: _fwd_kernel (:81) and _bwd_kernel (:112),
// joined there by a custom VJP (:201-212) and here by an autograd Function
// (ops/soft_dtw.py). The TPU kernels keep one lattice in VMEM, skewed so
// that an anti-diagonal is one vector row; the grid had one program per
// call, so the training loss launched one kernel per 256-frame chunk.
//
// Design: one block per lattice, every lattice of one call in one launch
// (the loss folds all its chunks into one call). A thread owns rows
// tid + k * blockDim.x, k < K, and the block walks the N + M - 1
// anti-diagonals with one __syncthreads() each, keeping the last diagonals
// in shared memory. The forward's softmin, the 1e10 sentinel and the
// validity masks are those of the Pallas forward, so exp underflows in the
// same cells; the backward keeps the Pallas clip bounds but forms its
// weights another way (see there). R goes to global memory skewed,
// R[l][d][i] = R_l(i, d - i), 1e10 off the lattice, so each diagonal is one
// coalesced row for both kernels; the forward reads D in its natural layout
// (L2 absorbs the stride), the backward needs only R.
//
// Bound: the bytes are D read once, R written and read once, dD written
// once (a few tens of MB at the training shape, ~0.01-0.02 ms at
// 3.35 TB/s), but no roofline shows the real limit: the N + M - 1
// diagonals form a serial chain of dependent steps (a barrier, shared
// loads and three exp and a log each), which sets the time of one lattice
// whatever the card's width. The lattices run side by side, one per SM.
#include "common.cuh"

namespace {

constexpr float kInf = 1e10f;  // ops/pallas_soft_dtw.py _INF

// ---------------------------------------------------------------- forward
template <int K>
__global__ void soft_dtw_fwd_kernel(const float* __restrict__ D, float* __restrict__ R,
                                    float* __restrict__ value, int N, int M, float gamma) {
  extern __shared__ float smem[];  // three diagonals of N floats: d, d-1, d-2
  const int ndiag = N + M - 1;
  const float* Dl = D + static_cast<size_t>(blockIdx.x) * N * M;
  float* Rl = R + static_cast<size_t>(blockIdx.x) * ndiag * N;
  for (int i = threadIdx.x; i < 3 * N; i += blockDim.x) smem[i] = kInf;

  float dcur[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    dcur[k] = (i == 0) ? Dl[0] : 0.0f;  // diagonal 0 holds only (0, 0)
  }
  float* prev2 = smem;
  float* prev = smem + N;
  float* cur = smem + 2 * N;
  __syncthreads();

  for (int d = 0; d < ndiag; ++d) {
    // prefetch the next diagonal's distances while this one is computed
    float dnext[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      const int j = d + 1 - i;
      dnext[k] = (i < N && j >= 0 && j < M) ? __ldg(Dl + static_cast<size_t>(i) * M + j) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i >= N) continue;
      const int j = d - i;
      float r = kInf;
      if (j >= 0 && j < M) {
        if (d == 0) {
          r = dcur[k];  // R[0,0] = D[0,0]
        } else {
          const float up = i > 0 ? prev[i - 1] : kInf;    // (i-1, j)
          const float left = prev[i];                      // (i, j-1)
          const float diag = i > 0 ? prev2[i - 1] : kInf;  // (i-1, j-1)
          const float m = fminf(fminf(up, left), diag);
          const float soft = m - gamma * logf(expf((m - up) / gamma) + expf((m - left) / gamma) +
                                              expf((m - diag) / gamma));
          r = dcur[k] + soft;
        }
      }
      Rl[static_cast<size_t>(d) * N + i] = r;
      cur[i] = r;
    }
    __syncthreads();
    float* t = prev2;
    prev2 = prev;
    prev = cur;
    cur = t;
#pragma unroll
    for (int k = 0; k < K; ++k) dcur[k] = dnext[k];
  }
  if (threadIdx.x == 0) value[blockIdx.x] = prev[N - 1];  // R(N-1, M-1)
}

// --------------------------------------------------------------- backward
// E(i,j) = dValue/dD(i,j) = sum over the successors n of (i,j) of E(n) w(n),
// w(n) the weight of (i,j) in n's softmin. The TPU kernel evaluates
// w(n) = exp((R(n) - R(i,j) - D(n)) / gamma), which recovers n's softmin
// term (size gamma) by subtracting numbers of size R: at the mel loss's
// lattices R reaches ~2e4, whose f32 spacing is 2e-3, so each weight is off
// by up to 1 % and E by several % after hundreds of steps. Here each cell
// recomputes its own softmin inputs from R, as the forward formed them,
// m = min(up, left, diag) and S = sum exp((m - a) / gamma), and a
// predecessor's weight is w = exp((m - R(i,j)) / gamma) / S: the same
// quantity, the derivative autograd takes of the forward. The TPU kernel's
// clip of the exponent to [-80, 30] is kept.
//
// Shared memory: three diagonals (d, d+1, d+2), each E, m and S of N rows.
struct Diag {
  float* e;
  float* m;
  float* s;
};

__device__ __forceinline__ Diag diag_buf(float* smem, int d, int N) {
  float* b = smem + (d % 3) * 3 * N;
  return {b, b + N, b + 2 * N};
}

__device__ __forceinline__ float weight(const Diag& n, int row, float r0, float gamma) {
  return n.e[row] * (expf(fminf(fmaxf((n.m[row] - r0) / gamma, -80.0f), 30.0f)) / n.s[row]);
}

// R of cell row i on skewed diagonal d of lattice Rl (INF off the lattice)
__device__ __forceinline__ float r_at(const float* Rl, int d, int i, int N) {
  return (d >= 0 && i >= 0) ? __ldg(Rl + static_cast<size_t>(d) * N + i) : kInf;
}

template <int K>
__global__ void soft_dtw_bwd_kernel(const float* __restrict__ R, const float* __restrict__ g,
                                    float* __restrict__ E, int N, int M, float gamma) {
  extern __shared__ float smem[];
  const int ndiag = N + M - 1;
  const float* Rl = R + static_cast<size_t>(blockIdx.x) * ndiag * N;
  float* El = E + static_cast<size_t>(blockIdx.x) * N * M;
  const float gl = g[blockIdx.x];
  // E 0, m and S 1, so a row off the lattice contributes nothing
  for (int i = threadIdx.x; i < 9 * N; i += blockDim.x) smem[i] = ((i / N) % 3 == 0) ? 0.0f : 1.0f;

  // the cell's own R and its predecessors' (up, left, diag), one diagonal ahead
  float r0[K], ru[K], rl[K], rd[K];
  const auto fetch = [&](int d, float* c, float* u, float* l, float* dg) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      c[k] = i < N ? r_at(Rl, d, i, N) : kInf;
      u[k] = i < N ? r_at(Rl, d - 1, i - 1, N) : kInf;
      l[k] = i < N ? r_at(Rl, d - 1, i, N) : kInf;
      dg[k] = i < N ? r_at(Rl, d - 2, i - 1, N) : kInf;
    }
  };
  fetch(ndiag - 1, r0, ru, rl, rd);
  __syncthreads();

  for (int d = ndiag - 1; d >= 0; --d) {
    float n0[K], nu[K], nl[K], nd[K];
    if (d > 0) fetch(d - 1, n0, nu, nl, nd);
    const Diag cur = diag_buf(smem, d, N);
    const Diag n1 = diag_buf(smem, d + 1, N);
    const Diag n2 = diag_buf(smem, d + 2, N);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i >= N) continue;
      const int j = d - i;
      float e = 0.0f, m = 1.0f, s = 1.0f;
      if (j >= 0 && j < M) {
        if (d == ndiag - 1) {
          e = 1.0f;  // seed: E(N-1, M-1) = 1
        } else {
          const bool va = i + 1 < N;  // (i+1, j): diagonal d+1, row i+1
          const bool vb = j + 1 < M;  // (i, j+1): diagonal d+1, row i
          const float ta = va ? weight(n1, i + 1, r0[k], gamma) : 0.0f;
          const float tb = vb ? weight(n1, i, r0[k], gamma) : 0.0f;
          const float tc = (va && vb) ? weight(n2, i + 1, r0[k], gamma) : 0.0f;  // (i+1, j+1)
          e = ta + tb + tc;
        }
        El[static_cast<size_t>(i) * M + j] = e * gl;
        // this cell's softmin inputs, as the forward formed them
        const float up = i > 0 ? ru[k] : kInf, left = rl[k], diag = i > 0 ? rd[k] : kInf;
        m = fminf(fminf(up, left), diag);
        s = expf((m - up) / gamma) + expf((m - left) / gamma) + expf((m - diag) / gamma);
      }
      cur.e[i] = e;
      cur.m[i] = m;
      cur.s[i] = s;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      r0[k] = n0[k];
      ru[k] = nu[k];
      rl[k] = nl[k];
      rd[k] = nd[k];
    }
  }
}

// rows per thread and threads per block for N rows
inline void block_shape(int N, int* K, int* threads) {
  *K = (N + 1023) / 1024;
  *threads = ((N + *K - 1) / *K + 31) / 32 * 32;
}

template <int K>
cudaError_t launch_fwd(const float* D, float* R, float* value, int L, int N, int M, float gamma,
                       int threads, cudaStream_t stream) {
  const int smem = 3 * N * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = lfs2::allow_smem(soft_dtw_fwd_kernel<K>, smem);
    if (err != cudaSuccess) return err;
  }
  soft_dtw_fwd_kernel<K><<<L, threads, smem, stream>>>(D, R, value, N, M, gamma);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_bwd(const float* R, const float* g, float* E, int L, int N, int M, float gamma,
                       int threads, cudaStream_t stream) {
  const int smem = 9 * N * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = lfs2::allow_smem(soft_dtw_bwd_kernel<K>, smem);
    if (err != cudaSuccess) return err;
  }
  soft_dtw_bwd_kernel<K><<<L, threads, smem, stream>>>(R, g, E, N, M, gamma);
  return cudaGetLastError();
}

}  // namespace

LFS2_DEFINE_ERROR_STRING

// D (L, N, M) f32 -> R (L, N + M - 1, N) f32 skewed, value (L,) f32
LFS2_EXPORT int lfs2_soft_dtw_fwd(const float* D, float* R, float* value, int L, int N, int M,
                                  float gamma, void* stream) {
  int K, threads;
  block_shape(N, &K, &threads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return static_cast<int>(launch_fwd<1>(D, R, value, L, N, M, gamma, threads, s));
    case 2: return static_cast<int>(launch_fwd<2>(D, R, value, L, N, M, gamma, threads, s));
    case 3: return static_cast<int>(launch_fwd<3>(D, R, value, L, N, M, gamma, threads, s));
    case 4: return static_cast<int>(launch_fwd<4>(D, R, value, L, N, M, gamma, threads, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// R (L, N + M - 1, N) from the forward, g (L,) the upstream gradient -> E (L, N, M) = g * dValue/dD
LFS2_EXPORT int lfs2_soft_dtw_bwd(const float* R, const float* g, float* E, int L, int N, int M,
                                  float gamma, void* stream) {
  int K, threads;
  block_shape(N, &K, &threads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return static_cast<int>(launch_bwd<1>(R, g, E, L, N, M, gamma, threads, s));
    case 2: return static_cast<int>(launch_bwd<2>(R, g, E, L, N, M, gamma, threads, s));
    case 3: return static_cast<int>(launch_bwd<3>(R, g, E, L, N, M, gamma, threads, s));
    case 4: return static_cast<int>(launch_bwd<4>(R, g, E, L, N, M, gamma, threads, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

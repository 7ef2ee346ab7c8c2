// A tiled matrix product on mma.sync for the wide routes (csrc/ffn_wide.cu,
// the FFN half at C = 384-768; csrc/resblock.cu's route past C = 256):
// C[M, N] = sum_k A(m, k) B(k, n) with f32 accumulation, one 128 x 128
// output tile a block of eight warps (2 x 4, each 64 x 32), K walked in
// chunks of 32 through two shared-memory stages: the next chunk's 16-byte
// loads are issued into registers before the current chunk's products and
// stored into the other stage after them, one barrier a chunk. bf16 runs
// m16n8k16 products; f32 runs split-TF32 m16n8k8 products (mma.cuh mma3:
// f32's digits on the tensor cores), both operands split as their
// fragments are read, each k-step's split products summed from zero on the
// tensor cores and added to the accumulators in f32.
//
// A and B come from functors that return 16 bytes (8 bf16 or 4 f32) of
// consecutive elements along the source's contiguous index: along k where
// KFAST, else along the tile's own rows. So one kernel reads row-major and
// transposed operands and gathers a dilated convolution's rows (the A of
// csrc/resblock.cu's wide route). The tile lies in shared memory
// k-contiguous, [row][k], whatever the source; a KFAST vector is one 16-byte
// store, another is stored element by element. An epilogue functor
// receives the accumulators and walks them with for_each_pair. A grid's z
// splits K (kper rows of K a block); a split-K epilogue adds atomically.
//
// Bound: the products (bf16 at 989 TFLOP/s, f32-accurate split TF32 at 165)
// for the FFN's and the convolutions' widths. This design keeps nothing of a
// fused chain on chip and runs mma.sync, not wgmma: it is the simple first
// route, timed in PERF.md against its bound.
#pragma once

#include "common.cuh"
#include "mma.cuh"

#include <cstdint>

namespace lfs2 {
namespace gemm {

constexpr int kBM = 128, kBN = 128, kBK = 32, kThreads = 256;

// the row stride of a [row][k] tile in shared memory, padded so that the
// fragment reads of eight rows by four k-pairs fall in distinct banks (and
// a row starts on 16 bytes)
template <typename T> struct Tile;
template <> struct Tile<__nv_bfloat16> { static constexpr int LD = kBK + 8; };
template <> struct Tile<float> { static constexpr int LD = kBK + 4; };

// dynamic shared memory of a block: two stages of the A and the B tile
template <typename T> constexpr int smem_bytes() {
  return 2 * 2 * kBM * Tile<T>::LD * static_cast<int>(sizeof(T));
}
// blocks an SM should hold: bf16 keeps two (its registers allow it), f32's
// split fragments take the registers of one
template <typename T> struct MinBlocks { static constexpr int value = 1; };
template <> struct MinBlocks<__nv_bfloat16> { static constexpr int value = 2; };

// elements of a 16-byte vector
template <typename T> __host__ __device__ constexpr int vec_elems() {
  return 16 / static_cast<int>(sizeof(T));
}

// X(r, k) = p[r * sr + k * sk]; vec(r, k): the 16 bytes from (r, k) along
// the index of stride 1 (sk == 1: k; else sr == 1: r), 16-byte aligned
template <typename T> struct Mat {
  const T* p;
  long long sr, sk;
  __device__ __forceinline__ uint4 vec(int r, int k) const {
    return *reinterpret_cast<const uint4*>(p + r * sr + static_cast<long long>(k) * sk);
  }
};

// One stage of a [kBM][kBK] tile in registers, NV vectors a thread. KFAST:
// a vector runs along k, thread i + 256 n takes row i / 4 (bf16; f32 i / 8)
// at its vector i % 4 (f32 % 8). Otherwise a vector runs along the rows: a
// warp takes four row vectors by eight k, so that its loads are 64-byte
// (f32 128-byte) runs and its element stores meet at most four rows a bank.
// Rows past R and k past kend read zeros: a KFAST vector lies wholly below
// kend (kend a multiple of the vector), another wholly below R (R a
// multiple of the vector; launch() checks both).
template <bool KFAST, typename T> struct Stage {
  static constexpr int VEC = vec_elems<T>(), NV = kBM * kBK / VEC / kThreads;
  static constexpr int KV = kBK / VEC, RV = kBM / VEC;
  uint4 v[NV];

  static __device__ __forceinline__ void at(int n, int& r, int& k) {
    const int i = threadIdx.x + n * kThreads;
    if (KFAST) {
      r = i / KV;
      k = (i % KV) * VEC;
    } else {
      r = ((i & 3) + 4 * (i / (4 * kBK))) * VEC;
      k = (i >> 2) % kBK;
    }
  }
  template <class Get>
  __device__ __forceinline__ void load(const Get& get, int r0, int k0, int R, int kend) {
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      int r, k;
      at(n, r, k);
      v[n] = (r0 + r < R && k0 + k < kend) ? get.vec(r0 + r, k0 + k) : make_uint4(0, 0, 0, 0);
    }
  }
  __device__ __forceinline__ void store(T* S) const {
    constexpr int LD = Tile<T>::LD;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      int r, k;
      at(n, r, k);
      if (KFAST) {
        *reinterpret_cast<uint4*>(S + r * LD + k) = v[n];
      } else {
        const T* e = reinterpret_cast<const T*>(&v[n]);
#pragma unroll
        for (int q = 0; q < VEC; ++q) S[(r + q) * LD + k] = e[q];
      }
    }
  }
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// one chunk's products into the warp's 64 x 32 accumulators: m-tile i
// (16 rows), n-tile j (8 columns)
template <typename T> struct Chunk;

// bf16 with FRESH: each k-step's products sum from zero on the tensor cores
// and are added to the accumulators with f32 adds, as f32's route (a long
// sum kept on the tensor cores truncates, and flips the bf16 roundings
// after it more often than a sum in f32 does)
template <> struct Chunk<__nv_bfloat16> {
  template <bool FRESH>
  static __device__ __forceinline__ void run(const __nv_bfloat16* As, const __nv_bfloat16* Bs,
                                             float (&acc)[4][4][4], int wm, int wn, int lane) {
    constexpr int LD = Tile<__nv_bfloat16>::LD;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat16* p = As + (wm * 64 + i * 16 + g) * LD + ks + 2 * t;
        a[i][0] = ld32(p);
        a[i][1] = ld32(p + 8 * LD);
        a[i][2] = ld32(p + 8);
        a[i][3] = ld32(p + 8 * LD + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* p = Bs + (wn * 32 + j * 8 + g) * LD + ks + 2 * t;
        b[j][0] = ld32(p);
        b[j][1] = ld32(p + 8);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (FRESH) {
            float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_bf16(part, a[i], b[j]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] += part[e];
          } else {
            mma_bf16(acc[i][j], a[i], b[j]);
          }
        }
    }
  }
};

// f32: each k-step's split products sum from zero on the tensor cores and
// are then added to the accumulators with f32 adds (as csrc/resblock.cu's
// f32 route: the tensor cores' f32 accumulation truncates, and over
// thousands of terms it drifts past f32's tolerance)
template <> struct Chunk<float> {
  template <bool FRESH>
  static __device__ __forceinline__ void run(const float* As, const float* Bs,
                                             float (&acc)[4][4][4], int wm, int wn, int lane) {
    constexpr int LD = Tile<float>::LD;
    const int g = lane >> 2, t = lane & 3;
    // one k-step's split fragments live at a time: unrolled, the k-steps'
    // fragments and the next stage's loads take every register and spill
#pragma unroll 1
    for (int ks = 0; ks < kBK; ks += 8) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* p = Bs + (wn * 32 + j * 8 + g) * LD + ks + t;
        split(p[0], bh[j][0], bl[j][0]);
        split(p[4], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* p = As + (wm * 64 + i * 16 + g) * LD + ks + t;
        uint32_t ah[4], al[4];
        split_a(p[0], p[8 * LD], p[4], p[8 * LD + 4], ah, al);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma3(part, ah, al, bh[j], bl[j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[e];
        }
      }
    }
  }
};

// f(m, n, j, v0, v1) for each accumulator pair (columns n, n + 1, in the
// warp's n-tile j) of the warp's tile whose row m is below M; mw, nw: the
// warp's first row, column
template <class Fn>
__device__ __forceinline__ void for_each_pair(const float (&acc)[4][4][4], int mw, int nw,
                                              int lane, int M, Fn&& f) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mw + i * 16 + g + 8 * h;
        if (m < M) f(m, nw + j * 8 + 2 * t, j, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
}

// cs[j][e]: a thread's sum over its rows of column nw + 8 j + 2 t + e; summed
// over the warp's eight lanes of equal t, added into dst by lanes 0-3. Every
// lane of the warp calls it.
__device__ __forceinline__ void column_sums_add(float (&cs)[4][2], int nw, int lane, float* dst) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = cs[j][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) atomicAdd(dst + nw + j * 8 + 2 * lane + e, v);
    }
}

// grid (N / kBN, ceil(M / kBM), ceil(K / kper)); N a multiple of kBN; kper
// a multiple of kBK; ep(acc, first row, first column, lane, M) per warp;
// FRESH: bf16 sums each k-step from zero (Chunk)
template <typename T, bool AK, bool BKF, class GA, class GB, class EP, bool FRESH = false>
__global__ void __launch_bounds__(kThreads, MinBlocks<T>::value)
gemm_kernel(const GA ga, const GB gb, const EP ep, int M, int N, int K, int kper) {
  constexpr int TILE = kBM * Tile<T>::LD;
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  T* As = reinterpret_cast<T*>(gemm_smem);   // stage s: As + s TILE, Bs + s TILE
  T* Bs = As + 2 * TILE;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int kb = blockIdx.z * kper;
  const int ke = min(K, kb + kper);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp >> 2, wn = warp & 3;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  Stage<AK, T> sa;
  Stage<BKF, T> sb;
  if (kb < ke) {
    sa.load(ga, m0, kb, M, ke);
    sb.load(gb, n0, kb, N, ke);
    sa.store(As);
    sb.store(Bs);
  }
  __syncthreads();
  int s = 0;
  for (int k0 = kb; k0 < ke; k0 += kBK, s ^= 1) {
    const bool more = k0 + kBK < ke;
    if (more) {
      sa.load(ga, m0, k0 + kBK, M, ke);
      sb.load(gb, n0, k0 + kBK, N, ke);
    }
    Chunk<T>::template run<FRESH>(As + s * TILE, Bs + s * TILE, acc, wm, wn, lane);
    if (more) {
      sa.store(As + (s ^ 1) * TILE);
      sb.store(Bs + (s ^ 1) * TILE);
    }
    __syncthreads();
  }
  ep(acc, m0 + wm * 64, n0 + wn * 32, lane, M);
}

// K rows a block of a split-K product takes: the blocks near two a streaming
// multiprocessor, at least 8 chunks each (ops/gemm.py split_k_rows mirrors it)
inline int split_k_rows(int tiles, int K) {
  const int chunks = (K + kBK - 1) / kBK;
  int splits = (2 * 132) / (tiles > 0 ? tiles : 1);
  const int most = (chunks + 7) / 8;
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  return ((chunks + splits - 1) / splits) * kBK;
}

// launch one product: grid from M, N, K and kper; records the launch.
// Refuses shapes a vector would straddle: a KFAST operand needs K and kper
// multiples of the vector, another its rows (M or N)
template <typename T, bool AK, bool BKF, class GA, class GB, class EP>
cudaError_t launch(const GA& ga, const GB& gb, const EP& ep, int M, int N, int K, int kper,
                   cudaStream_t s, int* rec) {
  constexpr int VEC = vec_elems<T>();
  if (N % kBN || kper % kBK || ((AK || BKF) && K % VEC) || (!AK && M % VEC))
    return cudaErrorInvalidValue;
  const dim3 grid(N / kBN, (M + kBM - 1) / kBM, (K + kper - 1) / kper);
  constexpr int smem = smem_bytes<T>();
  auto kern = gemm_kernel<T, AK, BKF, GA, GB, EP>;
  if (smem > 48 * 1024) {
    const cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, kThreads, smem, s>>>(ga, gb, ep, M, N, K, kper);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess && rec) {
    rec[0] = grid.x, rec[1] = grid.y, rec[2] = grid.z, rec[3] = smem, rec[4] = kBM;
  }
  return e;
}

}  // namespace gemm
}  // namespace lfs2

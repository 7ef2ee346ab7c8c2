// flash_attention: softmax(q k^T / sqrt(d)) v with a key-padding mask and
// hashed dropout on the probabilities, forward and backward.
//
// Replaces lightningfastspeech2_tpu/ops/pallas_attention.py _fwd_kernel and
// _bwd_kernel (flash_attention, joined by a custom VJP there and by an
// autograd Function here). q, k, v, o, do are (B, H, T, 128) in f32 or
// bf16; mask is (B, T) int32, nonzero = valid key. Padded queries are not
// masked (torch key_padding_mask semantics); a padded key's score is
// -1e30, as there.
//
// Forward. The TPU kept all of K/V in VMEM and took one softmax pass per
// row; a Hopper block's shared memory does not hold them, so each block
// owns 64 query rows and walks K/V in 64-row tiles with an online softmax.
// The running denominator sums the UNDROPPED p; only the kept p (rounded to
// the working dtype, as the TPU rounds p before P.V) enters the f32
// accumulator, and the output is acc / (denom * (1 - rate)), as at
// pallas_attention.py:124. The f32 log-sum-exp m + log(denom) per row is
// saved for the backward.
//
// Backward: the split the TPU compiler could not build. A dQ pass (one
// block per 64 query rows, keys walked in tiles) first forms
// D_i = rowsum(dO o O), which equals sum_j p_ij dp_ij with dropout too, and
// a K-major pass (one block per 64 keys, queries walked in tiles) forms dK
// and dV. Both recompute P from the saved log-sum-exp and the dropout mask
// from the hash; neither needs atomics, and dK/dV accumulate in f32
// registers (the TPU accumulated them across query tiles in bf16).
//
// Dropout: keep(query row r, key c) hashes the GLOBAL coordinates with
// seed_bh = seed + b * H + h (lfs2::attn_keep, bit for bit
// pallas_attention.py _dropout_keep), so every tiling agrees.
//
// What bounds it on an H100: operations (4 T^2 d per (b, h) forward, about
// 2.5x that backward) once the scores stay on chip, as they do here. The
// products are plain f32 FMAs on the CUDA cores over 4x4 / 4x8 register
// tiles fed from shared memory (simple first); tensor cores (wgmma) and a
// TMA pipeline are the next step.
#include "common.cuh"

namespace {

constexpr int D = 128;    // head dim, the only one taken
constexpr int BQ = 64;    // query rows per tile
constexpr int BK = 64;    // key rows per tile
constexpr int LDT = 68;   // row stride of transposed tiles (keeps float4 reads aligned)
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* mask;
  const int* seed;
  const void* o;
  const void* dout;
  void* out;      // o (forward) or dq (backward dQ pass)
  float* lse;
  float* dsum;    // D_i, written by the dQ pass
  void* dk;
  void* dv;
  int H, T;
  float scale;
  unsigned threshold;
  float inv_keep;
};

// rows [r0, r0 + 64) of a (T, 128) slab into row-major smem [64][128]
template <typename T>
__device__ __forceinline__ void load_rows(const T* x, int r0, float* dst) {
  for (int idx = threadIdx.x; idx < 64 * (D / 4); idx += kThreads) {
    const int r = idx / (D / 4), d4 = (idx % (D / 4)) * 4;
    float v[4];
    lfs2::load_vec<4>(x + static_cast<size_t>(r0 + r) * D + d4, v);
    *reinterpret_cast<float4*>(dst + r * D + d4) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// rows [r0, r0 + 64) of a (T, 128) slab into transposed smem [128][LDT]
// (neighbouring threads take neighbouring rows, so the stores do not
// conflict)
template <typename T>
__device__ __forceinline__ void load_rows_t(const T* x, int r0, float* dst) {
  for (int idx = threadIdx.x; idx < 64 * (D / 4); idx += kThreads) {
    const int r = idx % 64, d4 = (idx / 64) * 4;
    float v[4];
    lfs2::load_vec<4>(x + static_cast<size_t>(r0 + r) * D + d4, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[(d4 + i) * LDT + r] = v[i];
  }
}

// acc[i][j] += sum_d At[d][ty*4+i] * Bt[d][tx*4+j] over d < 128
__device__ __forceinline__ void mm_nt(const float* At, const float* Bt, float acc[4][4], int ty,
                                      int tx) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(At + d * LDT + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(Bt + d * LDT + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
  }
}

// acc[i][j] += sum_c A[c][ty*4+i] * Bm[c][tx*8+j] over c < 64; A is
// [64][LDT], Bm row-major [64][128]
__device__ __forceinline__ void mm_pv(const float* A, const float* Bm, float acc[4][8], int ty,
                                      int tx) {
#pragma unroll 4
  for (int c = 0; c < 64; ++c) {
    const float4 a = *reinterpret_cast<const float4*>(A + c * LDT + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(Bm + c * D + tx * 8);
    const float4 b1 = *reinterpret_cast<const float4*>(Bm + c * D + tx * 8 + 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * bv[j];
  }
}

// max / sum over the 16 threads (tx) that share a row group (ty)
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ unsigned seed_bh(const Params& p, int b, int h) {
  return static_cast<unsigned>(*p.seed) + static_cast<unsigned>(b * p.H + h);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fwd_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                 // [128][LDT]
  float* Kt = Qt + D * LDT;         // [128][LDT]
  float* Vs = Kt + D * LDT;         // [64][128]
  float* Pt = Vs + BK * D;          // [64 keys][LDT]
  int* mk = reinterpret_cast<int*>(Pt + BK * LDT);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ, T_len = p.T;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t base = (static_cast<size_t>(b) * p.H + h) * T_len * D;
  const T* q = static_cast<const T*>(p.q) + base;
  const T* k = static_cast<const T*>(p.k) + base;
  const T* v = static_cast<const T*>(p.v) + base;
  const unsigned sbh = seed_bh(p, b, h);
  const bool drop = p.threshold != 0u;

  load_rows_t(q, q0, Qt);
  float m[4], l[4], o[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) o[i][j] = 0.0f;
  }
  for (int k0 = 0; k0 < T_len; k0 += BK) {
    __syncthreads();
    load_rows_t(k, k0, Kt);
    load_rows(v, k0, Vs);
    if (threadIdx.x < BK) mk[threadIdx.x] = p.mask[static_cast<size_t>(b) * T_len + k0 + threadIdx.x];
    __syncthreads();
    float s[4][4] = {};
    mm_nt(Qt, Kt, s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = mk[tx * 4 + j] ? s[i][j] * p.scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = __expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pv = __expf(s[i][j] - m_new);
        rs += pv;
        if (drop && !lfs2::attn_keep(q0 + ty * 4 + i, k0 + tx * 4 + j, sbh, p.threshold)) pv = 0.0f;
        Pt[(tx * 4 + j) * LDT + ty * 4 + i] = lfs2::round_to<T>(pv);
      }
      l[i] = l[i] * alpha + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) o[i][j] *= alpha;
    }
    __syncthreads();
    mm_pv(Pt, Vs, o, ty, tx);
  }
  T* out = static_cast<T*>(p.out) + base;
  const size_t row_base = (static_cast<size_t>(b) * p.H + h) * T_len;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    const float norm = 1.0f / (l[i] * (drop ? 1.0f / p.inv_keep : 1.0f));
#pragma unroll
    for (int j = 0; j < 8; ++j) out[static_cast<size_t>(r) * D + tx * 8 + j] = lfs2::from_f<T>(o[i][j] * norm);
    if (tx == 0) p.lse[row_base + r] = m[i] + __logf(l[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dq_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                 // [128][LDT]
  float* dOt = Qt + D * LDT;
  float* Kt = dOt + D * LDT;
  float* Vt = Kt + D * LDT;
  float* Ks = Vt + D * LDT;         // [64][128]
  float* dSt = Ks + BK * D;         // [64 keys][LDT]
  float* lse = dSt + BK * LDT;      // [64]
  float* dsum = lse + BQ;           // [64]
  int* mk = reinterpret_cast<int*>(dsum + BQ);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ, T_len = p.T;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t base = (static_cast<size_t>(b) * p.H + h) * T_len * D;
  const size_t row_base = (static_cast<size_t>(b) * p.H + h) * T_len;
  const T* q = static_cast<const T*>(p.q) + base;
  const T* k = static_cast<const T*>(p.k) + base;
  const T* v = static_cast<const T*>(p.v) + base;
  const T* o = static_cast<const T*>(p.o) + base;
  const T* dout = static_cast<const T*>(p.dout) + base;
  const unsigned sbh = seed_bh(p, b, h);
  const bool drop = p.threshold != 0u;

  load_rows_t(q, q0, Qt);
  load_rows_t(dout, q0, dOt);
  // D_i = rowsum(dO o O), one warp per row
  for (int r = warp; r < BQ; r += kThreads / 32) {
    float a[4], c[4];
    lfs2::load_vec<4>(dout + static_cast<size_t>(q0 + r) * D + lane * 4, a);
    lfs2::load_vec<4>(o + static_cast<size_t>(q0 + r) * D + lane * 4, c);
    const float s = lfs2::warp_sum(a[0] * c[0] + a[1] * c[1] + a[2] * c[2] + a[3] * c[3]);
    if (lane == 0) {
      dsum[r] = s;
      p.dsum[row_base + q0 + r] = s;
      lse[r] = p.lse[row_base + q0 + r];
    }
  }
  float dq[4][8] = {};
  for (int k0 = 0; k0 < T_len; k0 += BK) {
    __syncthreads();
    load_rows_t(k, k0, Kt);
    load_rows_t(v, k0, Vt);
    load_rows(k, k0, Ks);
    if (threadIdx.x < BK) mk[threadIdx.x] = p.mask[static_cast<size_t>(b) * T_len + k0 + threadIdx.x];
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    mm_nt(Qt, Kt, s, ty, tx);
    mm_nt(dOt, Vt, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx * 4 + j;
        const float sv = mk[c] ? s[i][j] * p.scale : kNeg;
        const float pv = __expf(sv - lse[r]);
        float dpv = dp[i][j];
        if (drop) dpv = lfs2::attn_keep(q0 + r, k0 + c, sbh, p.threshold) ? dpv * p.inv_keep : 0.0f;
        dSt[c * LDT + r] = lfs2::round_to<T>(pv * (dpv - dsum[r]) * p.scale);
      }
    __syncthreads();
    mm_pv(dSt, Ks, dq, ty, tx);
  }
  T* dqo = static_cast<T*>(p.out) + base;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dqo[static_cast<size_t>(q0 + ty * 4 + i) * D + tx * 8 + j] = lfs2::from_f<T>(dq[i][j]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dkv_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;                 // [128][LDT]
  float* Vt = Kt + D * LDT;
  float* Qt = Vt + D * LDT;
  float* dOt = Qt + D * LDT;
  float* Qs = dOt + D * LDT;        // [64][128]
  float* dOs = Qs + BQ * D;         // [64][128]
  float* buf = dOs + BQ * D;        // [64 queries][LDT]: P_drop, then dS
  float* lse = buf + BQ * LDT;      // [64]
  float* dsum = lse + BQ;           // [64]
  int* mk = reinterpret_cast<int*>(dsum + BQ);

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BK, T_len = p.T;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t base = (static_cast<size_t>(b) * p.H + h) * T_len * D;
  const size_t row_base = (static_cast<size_t>(b) * p.H + h) * T_len;
  const T* q = static_cast<const T*>(p.q) + base;
  const T* k = static_cast<const T*>(p.k) + base;
  const T* v = static_cast<const T*>(p.v) + base;
  const T* dout = static_cast<const T*>(p.dout) + base;
  const unsigned sbh = seed_bh(p, b, h);
  const bool drop = p.threshold != 0u;

  load_rows_t(k, k0, Kt);
  load_rows_t(v, k0, Vt);
  if (threadIdx.x < BK) mk[threadIdx.x] = p.mask[static_cast<size_t>(b) * T_len + k0 + threadIdx.x];
  float dk[4][8] = {}, dv[4][8] = {};
  for (int q0 = 0; q0 < T_len; q0 += BQ) {
    __syncthreads();
    load_rows_t(q, q0, Qt);
    load_rows_t(dout, q0, dOt);
    load_rows(q, q0, Qs);
    load_rows(dout, q0, dOs);
    if (threadIdx.x < BQ) {
      lse[threadIdx.x] = p.lse[row_base + q0 + threadIdx.x];
      dsum[threadIdx.x] = p.dsum[row_base + q0 + threadIdx.x];
    }
    __syncthreads();
    // transposed scores: key c = ty*4+i, query r = tx*4+j
    float s[4][4] = {}, dp[4][4] = {}, ds[4][4];
    mm_nt(Kt, Qt, s, ty, tx);
    mm_nt(Vt, dOt, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = ty * 4 + i, r = tx * 4 + j;
        const float sv = mk[c] ? s[i][j] * p.scale : kNeg;
        const float pv = __expf(sv - lse[r]);
        float pd = pv, dpv = dp[i][j];
        if (drop) {
          const bool keep = lfs2::attn_keep(q0 + r, k0 + c, sbh, p.threshold);
          pd = keep ? pv * p.inv_keep : 0.0f;
          dpv = keep ? dpv * p.inv_keep : 0.0f;
        }
        buf[r * LDT + c] = lfs2::round_to<T>(pd);
        ds[i][j] = lfs2::round_to<T>(pv * (dpv - dsum[r]) * p.scale);
      }
    __syncthreads();
    mm_pv(buf, dOs, dv, ty, tx);   // dV[c] += sum_r P_drop[r][c] dO[r]
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) buf[(tx * 4 + j) * LDT + ty * 4 + i] = ds[i][j];
    __syncthreads();
    mm_pv(buf, Qs, dk, ty, tx);    // dK[c] += sum_r dS[r][c] Q[r]
  }
  T* dko = static_cast<T*>(p.dk) + base;
  T* dvo = static_cast<T*>(p.dv) + base;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const size_t at = static_cast<size_t>(k0 + ty * 4 + i) * D + tx * 8 + j;
      dko[at] = lfs2::from_f<T>(dk[i][j]);
      dvo[at] = lfs2::from_f<T>(dv[i][j]);
    }
}

constexpr int kFwdSmem = (2 * D * LDT + BK * D + BK * LDT) * 4 + BK * 4;
constexpr int kDqSmem = (4 * D * LDT + BK * D + BK * LDT + 2 * BQ) * 4 + BK * 4;
constexpr int kDkvSmem = (4 * D * LDT + 2 * BQ * D + BQ * LDT + 2 * BQ) * 4 + BK * 4;

template <typename K>
cudaError_t run(K kernel, int smem, const Params& p, int B, cudaStream_t s) {
  cudaError_t err = lfs2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.T / 64, p.H, B), kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

bool shape_ok(int B, int H, int T_len, int d) {
  return B >= 1 && H >= 1 && T_len >= 64 && T_len % 64 == 0 && d == D;
}

}  // namespace

LFS2_DEFINE_ERROR_STRING

// o and lse (B, H, T) f32 are written; seed is one int32 on the device
LFS2_EXPORT int lfs2_flash_attention_fwd(const void* q, const void* k, const void* v,
                                         const int* mask, const int* seed, void* o, float* lse,
                                         int B, int H, int T_len, int d, float scale,
                                         unsigned threshold, float inv_keep, int dtype,
                                         void* stream) {
  if (!shape_ok(B, H, T_len, d)) return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, mask, seed, nullptr, nullptr, o, lse, nullptr, nullptr, nullptr,
           H, T_len, scale, threshold, inv_keep};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == lfs2::kBF16 ? run(fwd_kernel<__nv_bfloat16>, kFwdSmem, p, B, s)
                                               : run(fwd_kernel<float>, kFwdSmem, p, B, s);
  return static_cast<int>(err);
}

// the dQ pass (which also writes dsum, (B, H, T) f32 scratch), then the
// K-major dK/dV pass, on one stream
LFS2_EXPORT int lfs2_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const int* mask, const int* seed, const void* o,
                                         const float* lse, const void* dout, void* dq, void* dk,
                                         void* dv, float* dsum, int B, int H, int T_len, int d,
                                         float scale, unsigned threshold, float inv_keep,
                                         int dtype, void* stream) {
  if (!shape_ok(B, H, T_len, d)) return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, mask, seed, o, dout, dq, const_cast<float*>(lse), dsum, dk, dv,
           H, T_len, scale, threshold, inv_keep};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == lfs2::kBF16 ? run(dq_kernel<__nv_bfloat16>, kDqSmem, p, B, s)
                                         : run(dq_kernel<float>, kDqSmem, p, B, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = dtype == lfs2::kBF16 ? run(dkv_kernel<__nv_bfloat16>, kDkvSmem, p, B, s)
                             : run(dkv_kernel<float>, kDkvSmem, p, B, s);
  return static_cast<int>(err);
}

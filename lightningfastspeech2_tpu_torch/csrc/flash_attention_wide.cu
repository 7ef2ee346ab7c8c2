// flash_attention at head dims past 256 (384, 512, ... any multiple of 128),
// both dtypes: softmax(q k^T / sqrt(d)) v with the key-padding mask and the
// hashed dropout of flash_attention.cu / flash_attention_sm90.cu, forward
// and backward, on the CUDA cores in f32.
//
// Replaces lightningfastspeech2_tpu/ops/pallas_attention.py _fwd_kernel and
// _bwd_kernel where the head dim is a multiple of 128 above 256 (the JAX
// kernel takes the whole head dim in one block). The tensor-core kernels
// hold a 128-column tile of each streamed row and a thread's accumulator of
// the whole head dim, which stop fitting past 256; this one is the simple
// design: every block owns 32 rows and one 128-column slice of its output,
// and forms the scores over the whole head dim 128 columns at a time, again
// for each slice (D / 128 times the score work of one pass).
//
//   forward   grid (T / 32 * D / 128, H, B): S = Q K^T of a 32-key tile,
//             the online softmax (the denominator sums the undropped p), P
//             dropped, rounded to T, then O[:, slice] += P V[:, slice];
//             o = acc / (l (1 - rate)), o32 the same in f32, lse m + log l
//   dQ pass   the same grid: D_i = rowsum(dO o O32) (slice 0 writes it), S
//             and dP = dO V^T per key tile, dS = P (dP' - D_i) / sqrt(d)
//             rounded to T, dQ[:, slice] += dS K[:, slice]
//   dK/dV     grid (T / 32 * D / 128, H, B) over 32 keys: S^T, dP^T over
//             32-query tiles, dV[:, slice] += P'^T dO[:, slice] and
//             dK[:, slice] += dS^T Q[:, slice]
//
// Rounding as the other routes: p and dS rounded to the working dtype before
// their products, everything summed in f32. A key tile past the item's last
// valid key is skipped (its p is exactly 0); an item with no valid key
// scores every key 0 (a uniform softmax), and a padded key's dS is 0.
#include "common.cuh"

#include <cstdint>
#include <type_traits>

namespace {

constexpr int BM = 32;       // a block's own rows
constexpr int BN = 32;       // rows of a streamed tile
constexpr int DC = 128;      // head-dim columns a chunk (and an output slice)
constexpr int LDC = DC + 1;  // row stride of a chunk in shared memory
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;

template <typename T> struct Params {
  const T* q;
  const T* k;
  const T* v;
  const int* mask;
  const int* seed;
  const float* o32;  // backward: the forward's f32 output
  const T* dout;
  T* out;            // o (forward) or dq (dQ pass)
  float* out32;      // forward: o in f32 (o itself for f32)
  float* lse;
  float* dsum;
  T* dk;
  T* dv;
  int H, len, D;  // heads, sequence length, head dim
  float scale;
  unsigned threshold;
  float inv_keep;
};

// rows [r0, r0 + 32) of a (T, D) slab, columns [c0, c0 + 128), into an f32
// chunk [32][LDC]
template <typename T>
__device__ __forceinline__ void load_chunk(const T* x, int D, int r0, int c0, float* dst) {
  for (int i = threadIdx.x; i < BM * DC; i += kThreads) {
    const int r = i / DC, c = i % DC;
    dst[r * LDC + c] = lfs2::to_f(x[static_cast<size_t>(r0 + r) * D + c0 + c]);
  }
}

// S[r][j] (+)= sum over a chunk of X[r] Y[j], for this thread's row r and
// its four columns j = cg + 8 i
__device__ __forceinline__ void chunk_dot(const float* X, const float* Y, int r, int cg,
                                          float (&s)[4]) {
#pragma unroll 8
  for (int d = 0; d < DC; ++d) {
    const float x = X[r * LDC + d];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] += x * Y[(cg + 8 * i) * LDC + d];
  }
}

// The score of a padded key (-1e30, or 0 when the item has no valid key)
// and, in kend, the end of the item's last valid key (T when there is
// none). Every thread of the block calls it.
__device__ __forceinline__ float key_extent(const int* mask, int T_len, int* kend) {
  __shared__ int s_last;
  if (threadIdx.x == 0) s_last = -1;
  __syncthreads();
  int last = -1;
  for (int i = threadIdx.x; i < T_len; i += kThreads)
    if (mask[i]) last = i;
  last = __reduce_max_sync(0xffffffffu, last);
  if ((threadIdx.x & 31) == 0) atomicMax(&s_last, last);
  __syncthreads();
  *kend = s_last < 0 ? T_len : s_last + 1;
  return s_last < 0 ? 0.0f : kNeg;
}

// max and sum over the eight threads of a row (lanes 8 r' .. 8 r' + 7)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int m = 1; m < 8; m <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int m = 1; m < 8; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// shared memory: four chunks (X, Y and the two of the backward's second
// product), a [32][BN + 1] probability tile and a second one
constexpr int kChunk = BM * LDC;
constexpr int kPT = BM * (BN + 1);
constexpr int kSmem = (4 * kChunk + 2 * kPT) * 4;

// Thread layout of a block: row r = tid / 8 of the block's 32, and cg =
// tid % 8: score columns cg + 8 i (i < 4) of a 32-wide tile, output
// columns cg + 8 i (i < 16) of the 128-column slice.
template <typename T>
__global__ void __launch_bounds__(kThreads) wide_fwd_kernel(const Params<T> p) {
  extern __shared__ float smem[];
  float* X = smem;
  float* Y = X + kChunk;
  float* Vs = Y + kChunk;
  float* P = Vs + 2 * kChunk;
  const int D = p.D, ns = D / DC, T_len = p.len;
  const int b = blockIdx.z, h = blockIdx.y, q0 = (blockIdx.x / ns) * BM, sl = blockIdx.x % ns;
  const int r = threadIdx.x >> 3, cg = threadIdx.x & 7;
  const size_t base = (static_cast<size_t>(b) * p.H + h) * T_len * D;
  const int* mask = p.mask + static_cast<size_t>(b) * T_len;
  const unsigned sbh = static_cast<unsigned>(*p.seed) + static_cast<unsigned>(b * p.H + h);
  const bool drop = p.threshold != 0u;
  int kend;
  const float mval = key_extent(mask, T_len, &kend);
  float m = -INFINITY, l = 0.0f, o[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = 0.0f;
  for (int k0 = 0; k0 < kend; k0 += BN) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int c0 = 0; c0 < D; c0 += DC) {
      __syncthreads();
      load_chunk(p.q + base, D, q0, c0, X);
      load_chunk(p.k + base, D, k0, c0, Y);
      __syncthreads();
      chunk_dot(X, Y, r, cg, s);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i] = mask[k0 + cg + 8 * i] ? s[i] * p.scale : mval;
      mx = fmaxf(mx, s[i]);
    }
    const float m_new = fmaxf(m, row_max(mx));
    const float alpha = __expf(m - m_new);
    m = m_new;
    float rs = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float e = __expf(s[i] - m);
      rs += e;
      if (drop && !lfs2::attn_keep(q0 + r, k0 + cg + 8 * i, sbh, p.threshold)) e = 0.0f;
      P[r * (BN + 1) + cg + 8 * i] = lfs2::round_to<T>(e);
    }
    l = l * alpha + row_sum(rs);
    load_chunk(p.v + base, D, k0, sl * DC, Vs);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] *= alpha;
    for (int j = 0; j < BN; ++j) {
      const float pj = P[r * (BN + 1) + j];
#pragma unroll
      for (int i = 0; i < 16; ++i) o[i] += pj * Vs[j * LDC + cg + 8 * i];
    }
  }
  const float n = (drop ? p.inv_keep : 1.0f) / l;
  const size_t at = base + static_cast<size_t>(q0 + r) * D + sl * DC + cg;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    p.out[at + 8 * i] = lfs2::from_f<T>(o[i] * n);
    if (p.out32 != reinterpret_cast<float*>(p.out)) p.out32[at + 8 * i] = o[i] * n;
  }
  if (sl == 0 && cg == 0) p.lse[(static_cast<size_t>(b) * p.H + h) * T_len + q0 + r] = m + logf(l);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) wide_dq_kernel(const Params<T> p) {
  extern __shared__ float smem[];
  float* Xq = smem;
  float* Yk = Xq + kChunk;
  float* Xd = Yk + kChunk;
  float* Yv = Xd + kChunk;
  float* dS = Yv + kChunk;
  const int D = p.D, ns = D / DC, T_len = p.len;
  const int b = blockIdx.z, h = blockIdx.y, q0 = (blockIdx.x / ns) * BM, sl = blockIdx.x % ns;
  const int r = threadIdx.x >> 3, cg = threadIdx.x & 7;
  const size_t base = (static_cast<size_t>(b) * p.H + h) * T_len * D;
  const size_t row = (static_cast<size_t>(b) * p.H + h) * T_len + q0 + r;
  const int* mask = p.mask + static_cast<size_t>(b) * T_len;
  const unsigned sbh = static_cast<unsigned>(*p.seed) + static_cast<unsigned>(b * p.H + h);
  const bool drop = p.threshold != 0u;
  int kend;
  const float mval = key_extent(mask, T_len, &kend);
  // D_i = rowsum(dO o O32) over the whole head dim, the row's eight threads
  float dd = 0.0f;
  for (int c = cg; c < D; c += 8) {
    const size_t at = base + static_cast<size_t>(q0 + r) * D + c;
    dd += lfs2::to_f(p.dout[at]) * p.o32[at];
  }
  dd = row_sum(dd);
  if (sl == 0 && cg == 0) p.dsum[row] = dd;
  const float lse = p.lse[row];
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
  for (int k0 = 0; k0 < kend; k0 += BN) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int c0 = 0; c0 < D; c0 += DC) {
      __syncthreads();
      load_chunk(p.q + base, D, q0, c0, Xq);
      load_chunk(p.k + base, D, k0, c0, Yk);
      load_chunk(p.dout + base, D, q0, c0, Xd);
      load_chunk(p.v + base, D, k0, c0, Yv);
      __syncthreads();
      chunk_dot(Xq, Yk, r, cg, s);
      chunk_dot(Xd, Yv, r, cg, dp);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = k0 + cg + 8 * i;
      const bool valid = mask[c] != 0;
      const float pv = __expf((valid ? s[i] * p.scale : mval) - lse);
      float dpv = dp[i];
      if (drop) dpv = lfs2::attn_keep(q0 + r, c, sbh, p.threshold) ? dpv * p.inv_keep : 0.0f;
      dS[r * (BN + 1) + cg + 8 * i] = lfs2::round_to<T>(valid ? pv * (dpv - dd) * p.scale : 0.0f);
    }
    __syncthreads();
    load_chunk(p.k + base, D, k0, sl * DC, Yk);
    __syncthreads();
    for (int j = 0; j < BN; ++j) {
      const float dj = dS[r * (BN + 1) + j];
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] += dj * Yk[j * LDC + cg + 8 * i];
    }
  }
  const size_t at = base + static_cast<size_t>(q0 + r) * D + sl * DC + cg;
#pragma unroll
  for (int i = 0; i < 16; ++i) p.out[at + 8 * i] = lfs2::from_f<T>(acc[i]);
}

// the block's 32 keys are its rows r; the streamed 32 queries its columns
template <typename T>
__global__ void __launch_bounds__(kThreads) wide_dkv_kernel(const Params<T> p) {
  extern __shared__ float smem[];
  float* Xk = smem;
  float* Yq = Xk + kChunk;
  float* Xv = Yq + kChunk;
  float* Yd = Xv + kChunk;
  float* Pd = Yd + kChunk;
  float* dS = Pd + kPT;
  const int D = p.D, ns = D / DC, T_len = p.len;
  const int b = blockIdx.z, h = blockIdx.y, k0 = (blockIdx.x / ns) * BM, sl = blockIdx.x % ns;
  const int r = threadIdx.x >> 3, cg = threadIdx.x & 7;
  const size_t base = (static_cast<size_t>(b) * p.H + h) * T_len * D;
  const size_t row_base = (static_cast<size_t>(b) * p.H + h) * T_len;
  const int* mask = p.mask + static_cast<size_t>(b) * T_len;
  const unsigned sbh = static_cast<unsigned>(*p.seed) + static_cast<unsigned>(b * p.H + h);
  const bool drop = p.threshold != 0u;
  int kend;
  const float mval = key_extent(mask, T_len, &kend);
  const size_t at = base + static_cast<size_t>(k0 + r) * D + sl * DC + cg;
  if (k0 >= kend) {  // keys past the item's last valid key: dK = dV = 0
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      p.dk[at + 8 * i] = lfs2::from_f<T>(0.0f);
      p.dv[at + 8 * i] = lfs2::from_f<T>(0.0f);
    }
    return;
  }
  const bool valid = mask[k0 + r] != 0;
  float dk[16], dv[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) dk[i] = dv[i] = 0.0f;
  for (int r0 = 0; r0 < T_len; r0 += BN) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int c0 = 0; c0 < D; c0 += DC) {
      __syncthreads();
      load_chunk(p.k + base, D, k0, c0, Xk);
      load_chunk(p.q + base, D, r0, c0, Yq);
      load_chunk(p.v + base, D, k0, c0, Xv);
      load_chunk(p.dout + base, D, r0, c0, Yd);
      __syncthreads();
      chunk_dot(Xk, Yq, r, cg, s);
      chunk_dot(Xv, Yd, r, cg, dp);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = r0 + cg + 8 * i;
      const float pv = __expf((valid ? s[i] * p.scale : mval) - p.lse[row_base + qr]);
      float pd = pv, dpv = dp[i];
      if (drop) {
        const bool keep = lfs2::attn_keep(qr, k0 + r, sbh, p.threshold);
        pd = keep ? pv * p.inv_keep : 0.0f;
        dpv = keep ? dpv * p.inv_keep : 0.0f;
      }
      Pd[r * (BN + 1) + cg + 8 * i] = lfs2::round_to<T>(pd);
      dS[r * (BN + 1) + cg + 8 * i] =
          lfs2::round_to<T>(valid ? pv * (dpv - p.dsum[row_base + qr]) * p.scale : 0.0f);
    }
    __syncthreads();
    load_chunk(p.q + base, D, r0, sl * DC, Yq);
    load_chunk(p.dout + base, D, r0, sl * DC, Yd);
    __syncthreads();
    for (int j = 0; j < BN; ++j) {
      const float pj = Pd[r * (BN + 1) + j], dj = dS[r * (BN + 1) + j];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        dv[i] += pj * Yd[j * LDC + cg + 8 * i];
        dk[i] += dj * Yq[j * LDC + cg + 8 * i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    p.dk[at + 8 * i] = lfs2::from_f<T>(dk[i]);
    p.dv[at + 8 * i] = lfs2::from_f<T>(dv[i]);
  }
}

// the grid (x, y, z) of each kernel's latest accepted launch: 0 the
// forward, 1 the dQ pass, 2 the dK/dV pass
int g_grid[3][3];

template <typename K, typename P>
cudaError_t run(K kernel, int which, const P& p, int B, cudaStream_t s) {
  cudaError_t err = lfs2::allow_smem(kernel, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.len / BM) * (p.D / DC), p.H, B);
  kernel<<<grid, kThreads, kSmem, s>>>(p);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    g_grid[which][0] = grid.x;
    g_grid[which][1] = grid.y;
    g_grid[which][2] = grid.z;
  }
  return err;
}

bool shape_ok(int B, int H, int T_len, int d) {
  return B >= 1 && H >= 1 && B <= 65535 && H <= 65535 && T_len >= BM && T_len % BM == 0 &&
         d > 256 && d % DC == 0;
}

template <typename T>
Params<T> params(const void* q, const void* k, const void* v, const int* mask, const int* seed,
                 int H, int T_len, int d, float scale, unsigned threshold, float inv_keep) {
  Params<T> p{};
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.mask = mask;
  p.seed = seed;
  p.H = H;
  p.len = T_len;
  p.D = d;
  p.scale = scale;
  p.threshold = threshold;
  p.inv_keep = inv_keep;
  return p;
}

template <typename T>
int fwd(const void* q, const void* k, const void* v, const int* mask, const int* seed, void* o,
        float* lse, float* o32, int B, int H, int T_len, int d, float scale, unsigned threshold,
        float inv_keep, void* stream) {
  if (!shape_ok(B, H, T_len, d) || std::is_same_v<T, float> != (o32 == o))
    return static_cast<int>(cudaErrorInvalidValue);
  auto p = params<T>(q, k, v, mask, seed, H, T_len, d, scale, threshold, inv_keep);
  p.out = static_cast<T*>(o);
  p.out32 = o32;
  p.lse = lse;
  return static_cast<int>(run(wide_fwd_kernel<T>, 0, p, B, static_cast<cudaStream_t>(stream)));
}

template <typename T>
int bwd(const void* q, const void* k, const void* v, const int* mask, const int* seed,
        const void* o32, const float* lse, const void* dout, void* dq, void* dk, void* dv,
        float* dsum, int B, int H, int T_len, int d, float scale, unsigned threshold,
        float inv_keep, void* stream) {
  if (!shape_ok(B, H, T_len, d)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto p = params<T>(q, k, v, mask, seed, H, T_len, d, scale, threshold, inv_keep);
  p.o32 = static_cast<const float*>(o32);
  p.dout = static_cast<const T*>(dout);
  p.out = static_cast<T*>(dq);
  p.lse = const_cast<float*>(lse);
  p.dsum = dsum;
  p.dk = static_cast<T*>(dk);
  p.dv = static_cast<T*>(dv);
  const cudaError_t err = run(wide_dq_kernel<T>, 1, p, B, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(run(wide_dkv_kernel<T>, 2, p, B, s));
}

}  // namespace

LFS2_DEFINE_ERROR_STRING

// One forward and one backward launcher per dtype, with the signature of
// flash_attention.cu's and flash_attention_sm90.cu's (the dtype is in the
// name): lfs2_flash_attention_wide_{f32,bf16}_{fwd,bwd}.
//
// forward: q, k, v (B, H, T, d), d a multiple of 128 above 256; o (the
// working dtype), o32 (f32; o itself for f32) and lse (B, H, T) f32 are
// written; seed is one int32 on the device. backward: the dQ pass (which
// also writes dsum, (B, H, T) f32 scratch), then the dK/dV pass, on one
// stream; o32 and lse are the forward's.
#define LFS2_WIDE_LAUNCHERS(NAME, T)                                                           \
  LFS2_EXPORT int lfs2_flash_attention_wide_##NAME##_fwd(                                      \
      const void* q, const void* k, const void* v, const int* mask, const int* seed, void* o,  \
      float* lse, float* o32, int B, int H, int T_len, int d, float scale, unsigned threshold, \
      float inv_keep, void* stream) {                                                          \
    return fwd<T>(q, k, v, mask, seed, o, lse, o32, B, H, T_len, d, scale, threshold,         \
                  inv_keep, stream);                                                           \
  }                                                                                            \
  LFS2_EXPORT int lfs2_flash_attention_wide_##NAME##_bwd(                                      \
      const void* q, const void* k, const void* v, const int* mask, const int* seed,           \
      const void* o32, const float* lse, const void* dout, void* dq, void* dk, void* dv,       \
      float* dsum, int B, int H, int T_len, int d, float scale, unsigned threshold,            \
      float inv_keep, void* stream) {                                                          \
    return bwd<T>(q, k, v, mask, seed, o32, lse, dout, dq, dk, dv, dsum, B, H, T_len, d,      \
                  scale, threshold, inv_keep, stream);                                         \
  }

LFS2_WIDE_LAUNCHERS(f32, float)
LFS2_WIDE_LAUNCHERS(bf16, __nv_bfloat16)

// copies into out[0..2] the grid of kernel `which` (0 the forward, 1 the dQ
// pass, 2 the dK/dV pass) as its latest launch was given it
LFS2_EXPORT int lfs2_flash_attention_wide_last_grid(int which, int* out) {
  if (which < 0 || which > 2) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 3; ++i) out[i] = g_grid[which][i];
  return 0;
}

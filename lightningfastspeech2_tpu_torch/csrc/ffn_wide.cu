// The FFN half of a conformer FFT block from C = 384: the training forward
// and backward of lightningfastspeech2_tpu/ops/pallas_ffn.py
// fused_ffn_ln_train (_ffn_train_kernel, _ffn_train_bwd_kernel) at every C
// from 384 that is a multiple of 128, and serving
// (fused_ffn_ln, _ffn_kernel) at every C from 768 that is a multiple of 128,
// past csrc/ffn_ln.cu's ffn_wide_kernel. Both dtypes; f32 forms its products
// as split TF32 (f32's digits), bf16 on bf16 mma.sync, both through
// csrc/gemm_mma.cuh.
//
// Design. At these widths a row's C-wide f32 accumulator does not fit a
// block's registers beside its h0 tile (64 rows x 768 f32 is 196 KB), so
// the chain is cut where a whole row or a whole column has to be seen, and
// each cut goes through device memory (L2 at the step's shapes):
//   forward   LN1 -> t1;  depthwise -> h0;  up = drop1(relu(h0 W1 + b1));
//             ff = drop2(up W2f + b2f);  out = LN2(t1 + ff)
//   backward  the forward's first four again; the LN2 backward -> dres, dff
//             (+ dg2, dbe2, db2f); dup = keep1 relu'(.) (dff W2f^T) / (1 - r)
//             (+ db1); dacc = dup W1^T; dW1 = h0^T dup; dW2f = up^T dff (split
//             over rows, added atomically); the depthwise backward -> dt1 (in
//             place of dres; dwd, dbd); the LN1 backward -> dz (dg1, dbe1).
// Rounding points as the TPU kernel's (ops/ffn.py ffn_ln_train_plain and
// ffn_ln_train_bwd_plain): t1, h0, up and the dropped up, dff and dup in the
// working dtype; every sum in f32. The dropout masks are _pos_keep bit for
// bit (common.cuh ffn_keep): keep1 (salt 1) at (row t, column f), keep2
// (salt 2) at (t, channel c). dup's ReLU mask is read off the dropped up
// (up > 0 where keep1 held and relu(pre) > 0).
//
// The row kernels hold a row in registers, C / 32 values a lane, up to C =
// 768 (kMaxLane); past it every row kernel reads its row again from L1 or
// L2 instead, with no per-lane array (any C, the same sums in the same
// order): the forward's LN1 and LN2 twice (wide_ln1_long_kernel,
// wide_ln2_long_kernel), the backward's LN2 and LN1 three times (the row's
// sums, the two means, the gradients: wide_ln2_bwd_long_kernel,
// wide_ln1_bwd_long_kernel), their column sums added into shared memory a
// row at a time.
//
// Bound: the products, 4 C F a row forward and 12 C F backward; the cuts
// add the bytes of t1, h0, up (F wide), ff and their gradients, each once.
// Every launch is recorded (lfs2_ffn_wide_last_launches) for ops/ffn.py
// ffn_plan to be held against.
#include "common.cuh"
#include "gemm_mma.cuh"

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using lfs2::from_f;
using lfs2::round_to;
using lfs2::to_f;
using lfs2::gemm::Mat;

constexpr int kMaxLane = 24;       // channels a lane holds in a row kernel: C / 32 at C = 768
constexpr int kWarpRows = 8;       // forward row kernels: one row a warp
constexpr int kRedRows = 128;      // backward row kernels: rows a block (16 a warp)
constexpr int kDwRows = 64, kDwCh = 64;  // depthwise tiles: rows of one item, channels
constexpr int kMaxK = 63;

int g_rec[16][5];
int g_n_rec = 0;

void record(dim3 grid, int smem, int rows) {
  if (g_n_rec >= 16) return;
  int* r = g_rec[g_n_rec++];
  r[0] = grid.x, r[1] = grid.y, r[2] = grid.z, r[3] = smem, r[4] = rows;
}

__device__ __forceinline__ void ln_stats(float s, float s2, int C, float eps, float& mean,
                                         float& inv) {
  s = lfs2::warp_sum(s);
  s2 = lfs2::warp_sum(s2);
  mean = s / C;
  inv = rsqrtf(fmaxf(s2 / C - mean * mean, 0.0f) + eps);
}

// LN1 (forward): t1 = LN1(z) in the working dtype; one row a warp
template <typename T>
__global__ void __launch_bounds__(256)
wide_ln1_kernel(const T* __restrict__ z, const float* __restrict__ lnp, T* __restrict__ t1,
                int rows, int C, float eps) {
  const int row = blockIdx.x * kWarpRows + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int n = C / 32;
  const size_t o = static_cast<size_t>(row) * C;
  float v[kMaxLane], s = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxLane; ++i)
    if (i < n) {
      v[i] = to_f(z[o + lane + 32 * i]);
      s += v[i];
      s2 += v[i] * v[i];
    }
  float mean, inv;
  ln_stats(s, s2, C, eps, mean, inv);
#pragma unroll
  for (int i = 0; i < kMaxLane; ++i)
    if (i < n) {
      const int c = lane + 32 * i;
      t1[o + c] = from_f<T>((v[i] - mean) * (inv * lnp[c]) + lnp[C + c]);
    }
}

// LN1 past kMaxLane: the row read twice, no per-lane arrays
template <typename T>
__global__ void __launch_bounds__(256)
wide_ln1_long_kernel(const T* __restrict__ z, const float* __restrict__ lnp,
                     T* __restrict__ t1, int rows, int C, float eps) {
  const int row = blockIdx.x * kWarpRows + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t o = static_cast<size_t>(row) * C;
  float s = 0.0f, s2 = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float v = to_f(z[o + c]);
    s += v;
    s2 += v * v;
  }
  float mean, inv;
  ln_stats(s, s2, C, eps, mean, inv);
  for (int c = lane; c < C; c += 32)
    t1[o + c] = from_f<T>((to_f(z[o + c]) - mean) * (inv * lnp[c]) + lnp[C + c]);
}

// LN2 (forward): out = LN2(t1 + ff)
template <typename T>
__global__ void __launch_bounds__(256)
wide_ln2_kernel(const T* __restrict__ t1, const float* __restrict__ ff,
                const float* __restrict__ lnp, T* __restrict__ out, int rows, int C, float eps) {
  const int row = blockIdx.x * kWarpRows + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int n = C / 32;
  const size_t o = static_cast<size_t>(row) * C;
  float v[kMaxLane], s = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxLane; ++i)
    if (i < n) {
      v[i] = to_f(t1[o + lane + 32 * i]) + ff[o + lane + 32 * i];
      s += v[i];
      s2 += v[i] * v[i];
    }
  float mean, inv;
  ln_stats(s, s2, C, eps, mean, inv);
#pragma unroll
  for (int i = 0; i < kMaxLane; ++i)
    if (i < n) {
      const int c = lane + 32 * i;
      out[o + c] = from_f<T>((v[i] - mean) * (inv * lnp[2 * C + c]) + lnp[3 * C + c]);
    }
}

// LN2 past kMaxLane: the row read twice, no per-lane arrays
template <typename T>
__global__ void __launch_bounds__(256)
wide_ln2_long_kernel(const T* __restrict__ t1, const float* __restrict__ ff,
                     const float* __restrict__ lnp, T* __restrict__ out, int rows, int C,
                     float eps) {
  const int row = blockIdx.x * kWarpRows + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t o = static_cast<size_t>(row) * C;
  float s = 0.0f, s2 = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float v = to_f(t1[o + c]) + ff[o + c];
    s += v;
    s2 += v * v;
  }
  float mean, inv;
  ln_stats(s, s2, C, eps, mean, inv);
  for (int c = lane; c < C; c += 32) {
    const float v = to_f(t1[o + c]) + ff[o + c];
    out[o + c] = from_f<T>((v - mean) * (inv * lnp[2 * C + c]) + lnp[3 * C + c]);
  }
}

// depthwise conv (SAME: left (k - 1) / 2): h0[t] = bd + sum_j t1[t + j - lpad] wd[j];
// a block owns kDwRows rows of one item and kDwCh channels, its t1 window
// in shared memory
template <typename T>
__global__ void __launch_bounds__(256)
wide_dw_kernel(const T* __restrict__ t1, const float* __restrict__ wd,
               const float* __restrict__ bd, T* __restrict__ h0, int T_len, int C, int k) {
  extern __shared__ float win[];  // (kDwRows + k - 1) x kDwCh
  const int t0 = blockIdx.x * kDwRows, c0 = blockIdx.y * kDwCh;
  const int lpad = (k - 1) / 2, W = kDwRows + k - 1;
  const size_t base = static_cast<size_t>(blockIdx.z) * T_len * C;
  for (int i = threadIdx.x; i < W * kDwCh; i += 256) {
    const int r = i / kDwCh, c = i % kDwCh, g = t0 - lpad + r;
    win[i] = (g >= 0 && g < T_len) ? to_f(t1[base + static_cast<size_t>(g) * C + c0 + c]) : 0.0f;
  }
  __syncthreads();
  const int c = threadIdx.x % kDwCh;
  const float bias = bd[c0 + c];
  for (int r = threadIdx.x / kDwCh; r < kDwRows && t0 + r < T_len; r += 256 / kDwCh) {
    float acc = 0.0f;
    for (int j = 0; j < k; ++j) acc += win[(r + j) * kDwCh + c] * wd[j * C + c0 + c];
    h0[base + static_cast<size_t>(t0 + r) * C + c0 + c] = from_f<T>(acc + bias);
  }
}

// ---- the products' epilogues ------------------------------------------------

// up = rnd(relu(acc + b1)); with dropout keep1 scaled, rounded again
template <typename T> struct UpEp {
  T* up;
  const float* b1;
  const int* seed;
  int T_len, F;
  unsigned thr;
  float ik;
  int drop;
  __device__ void operator()(const float (&acc)[4][4][4], int mw, int nw, int lane, int M) const {
    const int sd = drop ? *seed : 0;
    lfs2::gemm::for_each_pair(acc, mw, nw, lane, M, [&](int m, int n, int, float v0, float v1) {
      float o[2] = {v0 + b1[n], v1 + b1[n + 1]};
      const int b = m / T_len, t = m - b * T_len;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        o[e] = round_to<T>(fmaxf(o[e], 0.0f));
        if (drop)
          o[e] = lfs2::ffn_keep(t, n + e, lfs2::item_seed(sd, b), 1u, thr) ? round_to<T>(o[e] * ik)
                                                                           : 0.0f;
        up[static_cast<size_t>(m) * F + n + e] = from_f<T>(o[e]);
      }
    });
  }
};

// ff = acc + b2f; with dropout keep2 scaled (f32)
struct DownEp {
  float* ff;
  const float* b2f;
  const int* seed;
  int T_len, C;
  unsigned thr;
  float ik;
  int drop;
  __device__ void operator()(const float (&acc)[4][4][4], int mw, int nw, int lane, int M) const {
    const int sd = drop ? *seed : 0;
    lfs2::gemm::for_each_pair(acc, mw, nw, lane, M, [&](int m, int n, int, float v0, float v1) {
      float o[2] = {v0 + b2f[n], v1 + b2f[n + 1]};
      if (drop) {
        const int b = m / T_len, t = m - b * T_len;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          o[e] = lfs2::ffn_keep(t, n + e, lfs2::item_seed(sd, b), 2u, thr) ? o[e] * ik : 0.0f;
      }
      *reinterpret_cast<float2*>(ff + static_cast<size_t>(m) * C + n) = make_float2(o[0], o[1]);
    });
  }
};

// dup = (up > 0) acc / (1 - r), rounded; db1 sums it unrounded
template <typename T> struct DupEp {
  T* dup;
  const T* up;
  float* db1;
  int F;
  float ik;
  __device__ void operator()(const float (&acc)[4][4][4], int mw, int nw, int lane, int M) const {
    float cs[4][2] = {};
    lfs2::gemm::for_each_pair(acc, mw, nw, lane, M, [&](int m, int n, int j, float v0, float v1) {
      const size_t o = static_cast<size_t>(m) * F + n;
      const float a = to_f(up[o]) > 0.0f ? v0 * ik : 0.0f;
      const float b = to_f(up[o + 1]) > 0.0f ? v1 * ik : 0.0f;
      dup[o] = from_f<T>(a);
      dup[o + 1] = from_f<T>(b);
      cs[j][0] += a;
      cs[j][1] += b;
    });
    lfs2::gemm::column_sums_add(cs, nw, lane, db1);
  }
};

// a plain f32 store (dacc), or (atomic) an add into a zeroed f32 buffer
// (the weight gradients, split over rows)
template <bool ADD> struct StoreEp {
  float* dst;
  int N;
  __device__ void operator()(const float (&acc)[4][4][4], int mw, int nw, int lane, int M) const {
    lfs2::gemm::for_each_pair(acc, mw, nw, lane, M, [&](int m, int n, int, float v0, float v1) {
      float* p = dst + static_cast<size_t>(m) * N + n;
      if (ADD) {
        atomicAdd(p, v0);
        atomicAdd(p + 1, v1);
      } else {
        *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
      }
    });
  }
};

// ---- the backward's row kernels -------------------------------------------
// A block owns kRedRows rows, 16 a warp; the column sums of its rows meet
// in shared memory and are added into dvec once a block.

// after the block's barrier, adds shared red[NSUM][C] into dvec's rows a0,
// a1, a2 of (6, C)
template <int NSUM>
__device__ __forceinline__ void add_block_sums(const float* red, float* dvec, int a0, int a1,
                                               int a2, int C) {
  __syncthreads();
  for (int i = threadIdx.x; i < NSUM * C; i += 256) {
    const int q = i / C;
    atomicAdd(dvec + (q == 0 ? a0 : q == 1 ? a1 : a2) * C + i % C, red[i]);
  }
}

// adds a lane's partials of NSUM column sums into shared red[NSUM][C], then
// red into dvec (add_block_sums)
template <int NSUM>
__device__ __forceinline__ void block_column_sums(float (&part)[NSUM][kMaxLane], float* red,
                                                  float* dvec, int a0, int a1, int a2, int C) {
  const int lane = threadIdx.x & 31, n = C / 32;
#pragma unroll
  for (int q = 0; q < NSUM; ++q)
#pragma unroll
    for (int i = 0; i < kMaxLane; ++i)
      if (i < n) atomicAdd(red + q * C + lane + 32 * i, part[q][i]);
  add_block_sums<NSUM>(red, dvec, a0, a1, a2, C);
}

// the LN2 backward: x = t1 + ff; dres = inv (dy g2 - mean(dy g2) - xh
// mean(dy g2 xh)); dff = keep2 dres / (1 - r), rounded; dg2, dbe2, db2f
template <typename T>
__global__ void __launch_bounds__(256)
wide_ln2_bwd_kernel(const T* __restrict__ t1, const float* __restrict__ ff,
                    const T* __restrict__ dout, const float* __restrict__ lnp,
                    const int* __restrict__ seed, float* __restrict__ dres, T* __restrict__ dff,
                    float* __restrict__ dvec, int rows, int T_len, int C, float eps,
                    unsigned thr, float ik) {
  extern __shared__ float red[];  // (3, C)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n = C / 32;
  for (int i = threadIdx.x; i < 3 * C; i += 256) red[i] = 0.0f;
  __syncthreads();
  const int sd = *seed;
  float part[3][kMaxLane];
#pragma unroll
  for (int i = 0; i < kMaxLane; ++i) part[0][i] = part[1][i] = part[2][i] = 0.0f;
  for (int rr = warp; rr < kRedRows; rr += 8) {
    const int row = blockIdx.x * kRedRows + rr;
    if (row >= rows) break;
    const size_t o = static_cast<size_t>(row) * C;
    const int b = row / T_len, t = row - b * T_len;
    const unsigned sb = lfs2::item_seed(sd, b);
    float x[kMaxLane], dy[kMaxLane], s = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxLane; ++i)
      if (i < n) {
        const int c = lane + 32 * i;
        x[i] = to_f(t1[o + c]) + ff[o + c];
        dy[i] = to_f(dout[o + c]);
        s += x[i];
        s2 += x[i] * x[i];
      }
    float mean, inv;
    ln_stats(s, s2, C, eps, mean, inv);
    float m1 = 0.0f, m2 = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxLane; ++i)
      if (i < n) {
        x[i] = (x[i] - mean) * inv;
        const float dyg = dy[i] * lnp[2 * C + lane + 32 * i];
        m1 += dyg;
        m2 += dyg * x[i];
      }
    m1 = lfs2::warp_sum(m1) / C;
    m2 = lfs2::warp_sum(m2) / C;
#pragma unroll
    for (int i = 0; i < kMaxLane; ++i)
      if (i < n) {
        const int c = lane + 32 * i;
        const float dr = inv * (dy[i] * lnp[2 * C + c] - m1 - x[i] * m2);
        const float df = lfs2::ffn_keep(t, c, sb, 2u, thr) ? dr * ik : 0.0f;
        dres[o + c] = dr;
        dff[o + c] = from_f<T>(df);
        part[0][i] += dy[i] * x[i];
        part[1][i] += dy[i];
        part[2][i] += df;
      }
  }
  block_column_sums<3>(part, red, dvec, 2, 3, 5, C);
}

// the LN2 backward past kMaxLane: the row read three times, no per-lane
// arrays; the column sums go into shared red a row at a time
template <typename T>
__global__ void __launch_bounds__(256)
wide_ln2_bwd_long_kernel(const T* __restrict__ t1, const float* __restrict__ ff,
                         const T* __restrict__ dout, const float* __restrict__ lnp,
                         const int* __restrict__ seed, float* __restrict__ dres,
                         T* __restrict__ dff, float* __restrict__ dvec, int rows, int T_len, int C,
                         float eps, unsigned thr, float ik) {
  extern __shared__ float red[];  // (3, C)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < 3 * C; i += 256) red[i] = 0.0f;
  __syncthreads();
  const int sd = *seed;
  for (int rr = warp; rr < kRedRows; rr += 8) {
    const int row = blockIdx.x * kRedRows + rr;
    if (row >= rows) break;
    const size_t o = static_cast<size_t>(row) * C;
    const int b = row / T_len, t = row - b * T_len;
    const unsigned sb = lfs2::item_seed(sd, b);
    float s = 0.0f, s2 = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float x = to_f(t1[o + c]) + ff[o + c];
      s += x;
      s2 += x * x;
    }
    float mean, inv;
    ln_stats(s, s2, C, eps, mean, inv);
    float m1 = 0.0f, m2 = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float x = (to_f(t1[o + c]) + ff[o + c] - mean) * inv;
      const float dyg = to_f(dout[o + c]) * lnp[2 * C + c];
      m1 += dyg;
      m2 += dyg * x;
    }
    m1 = lfs2::warp_sum(m1) / C;
    m2 = lfs2::warp_sum(m2) / C;
    for (int c = lane; c < C; c += 32) {
      const float x = (to_f(t1[o + c]) + ff[o + c] - mean) * inv;
      const float dy = to_f(dout[o + c]);
      const float dr = inv * (dy * lnp[2 * C + c] - m1 - x * m2);
      const float df = lfs2::ffn_keep(t, c, sb, 2u, thr) ? dr * ik : 0.0f;
      dres[o + c] = dr;
      dff[o + c] = from_f<T>(df);
      atomicAdd(red + c, dy * x);
      atomicAdd(red + C + c, dy);
      atomicAdd(red + 2 * C + c, df);
    }
  }
  add_block_sums<3>(red, dvec, 2, 3, 5, C);
}

// the depthwise backward and its weights' gradients: dt1[t] = dres[t] +
// sum_j dacc[t - j + lpad] wd[j] (written over dres); dwd[j] += sum_t
// t1[t + j - lpad] dacc[t]; dbd += sum_t dacc[t]. Tiles as wide_dw_kernel's.
template <typename T>
__global__ void __launch_bounds__(256)
wide_dw_bwd_kernel(const T* __restrict__ t1, const float* __restrict__ dacc,
                   const float* __restrict__ wd, float* __restrict__ dt1,
                   float* __restrict__ dwd, float* __restrict__ dvec, int T_len, int C, int k) {
  extern __shared__ float sm[];
  const int W = kDwRows + k - 1, lpad = (k - 1) / 2, rpad = k - 1 - lpad;
  float* daw = sm;                 // dacc rows t0 - rpad ..
  float* t1w = sm + W * kDwCh;     // t1 rows t0 - lpad ..
  float* red = t1w + W * kDwCh;    // (k + 1) x kDwCh: dwd, then dbd
  const int t0 = blockIdx.x * kDwRows, c0 = blockIdx.y * kDwCh;
  const size_t base = static_cast<size_t>(blockIdx.z) * T_len * C;
  for (int i = threadIdx.x; i < W * kDwCh; i += 256) {
    const int r = i / kDwCh, c = i % kDwCh;
    const int ga = t0 - rpad + r, gt = t0 - lpad + r;
    daw[i] = (ga >= 0 && ga < T_len) ? dacc[base + static_cast<size_t>(ga) * C + c0 + c] : 0.0f;
    t1w[i] = (gt >= 0 && gt < T_len) ? to_f(t1[base + static_cast<size_t>(gt) * C + c0 + c]) : 0.0f;
  }
  for (int i = threadIdx.x; i < (k + 1) * kDwCh; i += 256) red[i] = 0.0f;
  __syncthreads();
  const int c = threadIdx.x % kDwCh, rg = threadIdx.x / kDwCh;
  for (int r = rg; r < kDwRows && t0 + r < T_len; r += 256 / kDwCh) {
    float s = 0.0f;
    for (int j = 0; j < k; ++j) s += daw[(r + k - 1 - j) * kDwCh + c] * wd[j * C + c0 + c];
    const size_t o = base + static_cast<size_t>(t0 + r) * C + c0 + c;
    dt1[o] += s;
  }
  // rows past T hold dacc 0 in the window, so they add nothing
  for (int j = 0; j <= k; ++j) {
    float s = 0.0f;
    for (int r = rg; r < kDwRows; r += 256 / kDwCh)
      s += (j < k ? t1w[(r + j) * kDwCh + c] : 1.0f) * daw[(r + rpad) * kDwCh + c];
    atomicAdd(red + j * kDwCh + c, s);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < (k + 1) * kDwCh; i += 256) {
    const int j = i / kDwCh, cc = c0 + i % kDwCh;
    atomicAdd(j < k ? dwd + j * C + cc : dvec + 4 * C + cc, red[i]);
  }
}

// the LN1 backward: dz = inv (dt1 g1 - mean(dt1 g1) - xh mean(dt1 g1 xh));
// dg1, dbe1
template <typename T>
__global__ void __launch_bounds__(256)
wide_ln1_bwd_kernel(const T* __restrict__ z, const float* __restrict__ dt1,
                    const float* __restrict__ lnp, T* __restrict__ dz, float* __restrict__ dvec,
                    int rows, int C, float eps) {
  extern __shared__ float red[];  // (2, C)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n = C / 32;
  for (int i = threadIdx.x; i < 2 * C; i += 256) red[i] = 0.0f;
  __syncthreads();
  float part[2][kMaxLane];
#pragma unroll
  for (int i = 0; i < kMaxLane; ++i) part[0][i] = part[1][i] = 0.0f;
  for (int rr = warp; rr < kRedRows; rr += 8) {
    const int row = blockIdx.x * kRedRows + rr;
    if (row >= rows) break;
    const size_t o = static_cast<size_t>(row) * C;
    float x[kMaxLane], d[kMaxLane], s = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxLane; ++i)
      if (i < n) {
        x[i] = to_f(z[o + lane + 32 * i]);
        d[i] = dt1[o + lane + 32 * i];
        s += x[i];
        s2 += x[i] * x[i];
      }
    float mean, inv;
    ln_stats(s, s2, C, eps, mean, inv);
    float m1 = 0.0f, m2 = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxLane; ++i)
      if (i < n) {
        x[i] = (x[i] - mean) * inv;
        const float dyg = d[i] * lnp[lane + 32 * i];
        m1 += dyg;
        m2 += dyg * x[i];
      }
    m1 = lfs2::warp_sum(m1) / C;
    m2 = lfs2::warp_sum(m2) / C;
#pragma unroll
    for (int i = 0; i < kMaxLane; ++i)
      if (i < n) {
        const int c = lane + 32 * i;
        dz[o + c] = from_f<T>(inv * (d[i] * lnp[c] - m1 - x[i] * m2));
        part[0][i] += d[i] * x[i];
        part[1][i] += d[i];
      }
  }
  block_column_sums<2>(part, red, dvec, 0, 1, 0, C);
}

// the LN1 backward past kMaxLane: the row read three times, no per-lane
// arrays; the column sums go into shared red a row at a time
template <typename T>
__global__ void __launch_bounds__(256)
wide_ln1_bwd_long_kernel(const T* __restrict__ z, const float* __restrict__ dt1,
                         const float* __restrict__ lnp, T* __restrict__ dz,
                         float* __restrict__ dvec, int rows, int C, float eps) {
  extern __shared__ float red[];  // (2, C)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < 2 * C; i += 256) red[i] = 0.0f;
  __syncthreads();
  for (int rr = warp; rr < kRedRows; rr += 8) {
    const int row = blockIdx.x * kRedRows + rr;
    if (row >= rows) break;
    const size_t o = static_cast<size_t>(row) * C;
    float s = 0.0f, s2 = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float x = to_f(z[o + c]);
      s += x;
      s2 += x * x;
    }
    float mean, inv;
    ln_stats(s, s2, C, eps, mean, inv);
    float m1 = 0.0f, m2 = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float x = (to_f(z[o + c]) - mean) * inv;
      const float dyg = dt1[o + c] * lnp[c];
      m1 += dyg;
      m2 += dyg * x;
    }
    m1 = lfs2::warp_sum(m1) / C;
    m2 = lfs2::warp_sum(m2) / C;
    for (int c = lane; c < C; c += 32) {
      const float x = (to_f(z[o + c]) - mean) * inv;
      const float d = dt1[o + c];
      dz[o + c] = from_f<T>(inv * (d * lnp[c] - m1 - x * m2));
      atomicAdd(red + c, d * x);
      atomicAdd(red + C + c, d);
    }
  }
  add_block_sums<2>(red, dvec, 0, 1, 0, C);
}

// ---- the launches ------------------------------------------------------------

template <typename T> struct Wide {
  const T* z;
  const T* dout;
  T* out;
  const float* wd;
  const float* b1;
  const float* lnp;
  const T* w1;    // (C, F)
  const T* w2f;   // (F, C)
  const T* w1t;   // W1^T (F, C): the up product's B, k-contiguous
  const T* w2ft;  // W2f^T (C, F): the down product's B
  const int* seed;
  T* t1;
  T* h0;
  T* up;  // (B T, F)
  float* ff;
  float* dres;  // then dt1
  T* dff;
  T* dup;  // (B T, F)
  float* dacc;
  T* dz;
  float* dwd;
  float* dw1;
  float* dw2f;
  float* db1;
  float* dvec;
  int B, T_len, C, F, k;
  float eps, ik;
  unsigned thr;
  int drop;
};

template <typename K> cudaError_t opt_in(K kernel, int smem) {
  return smem > 48 * 1024 ? lfs2::allow_smem(kernel, smem) : cudaSuccess;
}

#define LFS2_TRY(x)                          \
  do {                                       \
    const cudaError_t e_ = (x);              \
    if (e_ != cudaSuccess) return e_;        \
  } while (0)

// the forward's launches (and the backward's first four): LN1, depthwise,
// up, down; then, unless `chain`, LN2 into out (past kMaxLane lanes of a
// row, the row kernels that read it twice)
template <typename T> cudaError_t forward(const Wide<T>& a, bool chain, cudaStream_t s) {
  namespace gm = lfs2::gemm;
  const int M = a.B * a.T_len, C = a.C, F = a.F;
  const bool long_rows = C > 32 * kMaxLane;
  const dim3 rows8((M + kWarpRows - 1) / kWarpRows);
  if (long_rows)
    wide_ln1_long_kernel<T><<<rows8, 256, 0, s>>>(a.z, a.lnp, a.t1, M, C, a.eps);
  else
    wide_ln1_kernel<T><<<rows8, 256, 0, s>>>(a.z, a.lnp, a.t1, M, C, a.eps);
  LFS2_TRY(cudaGetLastError());
  record(rows8, 0, kWarpRows);
  const dim3 dgrid((a.T_len + kDwRows - 1) / kDwRows, C / kDwCh, a.B);
  const int dsmem = (kDwRows + a.k - 1) * kDwCh * 4;
  LFS2_TRY(opt_in(wide_dw_kernel<T>, dsmem));
  wide_dw_kernel<T><<<dgrid, 256, dsmem, s>>>(a.t1, a.wd, a.lnp + 4 * C, a.h0, a.T_len, C, a.k);
  LFS2_TRY(cudaGetLastError());
  record(dgrid, dsmem, kDwRows);
  int rec[5];
  LFS2_TRY((gm::launch<T, true, true>(Mat<T>{a.h0, C, 1}, Mat<T>{a.w1t, C, 1},
                                       UpEp<T>{a.up, a.b1, a.seed, a.T_len, F, a.thr, a.ik, a.drop},
                                       M, F, C, C, s, rec)));
  record(dim3(rec[0], rec[1], rec[2]), rec[3], rec[4]);
  LFS2_TRY((gm::launch<T, true, true>(Mat<T>{a.up, F, 1}, Mat<T>{a.w2ft, F, 1},
                                       DownEp{a.ff, a.lnp + 5 * C, a.seed, a.T_len, C, a.thr, a.ik,
                                              a.drop},
                                       M, C, F, F, s, rec)));
  record(dim3(rec[0], rec[1], rec[2]), rec[3], rec[4]);
  if (chain) return cudaSuccess;
  if (long_rows)
    wide_ln2_long_kernel<T><<<rows8, 256, 0, s>>>(a.t1, a.ff, a.lnp, a.out, M, C, a.eps);
  else
    wide_ln2_kernel<T><<<rows8, 256, 0, s>>>(a.t1, a.ff, a.lnp, a.out, M, C, a.eps);
  LFS2_TRY(cudaGetLastError());
  record(rows8, 0, kWarpRows);
  return cudaSuccess;
}

template <typename T> cudaError_t backward(const Wide<T>& a, cudaStream_t s) {
  namespace gm = lfs2::gemm;
  LFS2_TRY(forward(a, true, s));
  const int M = a.B * a.T_len, C = a.C, F = a.F;
  const bool long_rows = C > 32 * kMaxLane;
  const dim3 rgrid((M + kRedRows - 1) / kRedRows);
  auto ln2_bwd = long_rows ? wide_ln2_bwd_long_kernel<T> : wide_ln2_bwd_kernel<T>;
  LFS2_TRY(opt_in(ln2_bwd, 3 * C * 4));
  ln2_bwd<<<rgrid, 256, 3 * C * 4, s>>>(a.t1, a.ff, a.dout, a.lnp, a.seed, a.dres, a.dff, a.dvec,
                                        M, a.T_len, C, a.eps, a.thr, a.ik);
  LFS2_TRY(cudaGetLastError());
  record(rgrid, 3 * C * 4, kRedRows);
  int rec[5];
  // dup = keep1 relu'(pre) (dff W2f^T) / (1 - r): B(k = c, n = f) = W2f[f, c]
  LFS2_TRY((gm::launch<T, true, true>(Mat<T>{a.dff, C, 1}, Mat<T>{a.w2f, C, 1},
                                      DupEp<T>{a.dup, a.up, a.db1, F, a.ik}, M, F, C, C, s,
                                      rec)));
  record(dim3(rec[0], rec[1], rec[2]), rec[3], rec[4]);
  // dacc = dup W1^T: B(k = f, n = c) = W1[c, f]
  LFS2_TRY((gm::launch<T, true, true>(Mat<T>{a.dup, F, 1}, Mat<T>{a.w1, F, 1},
                                      StoreEp<false>{a.dacc, C}, M, C, F, F, s, rec)));
  record(dim3(rec[0], rec[1], rec[2]), rec[3], rec[4]);
  // dW1 (C, F) = h0^T dup and dW2f (F, C) = up^T dff, K = the B T rows
  const int kper = gm::split_k_rows((C / gm::kBM) * (F / gm::kBN), M);
  LFS2_TRY((gm::launch<T, false, false>(Mat<T>{a.h0, 1, C}, Mat<T>{a.dup, 1, F},
                                        StoreEp<true>{a.dw1, F}, C, F, M, kper, s, rec)));
  record(dim3(rec[0], rec[1], rec[2]), rec[3], rec[4]);
  LFS2_TRY((gm::launch<T, false, false>(Mat<T>{a.up, 1, F}, Mat<T>{a.dff, 1, C},
                                        StoreEp<true>{a.dw2f, C}, F, C, M, kper, s, rec)));
  record(dim3(rec[0], rec[1], rec[2]), rec[3], rec[4]);
  const dim3 dgrid((a.T_len + kDwRows - 1) / kDwRows, C / kDwCh, a.B);
  const int dsmem = (2 * (kDwRows + a.k - 1) + a.k + 1) * kDwCh * 4;
  LFS2_TRY(opt_in(wide_dw_bwd_kernel<T>, dsmem));
  wide_dw_bwd_kernel<T><<<dgrid, 256, dsmem, s>>>(a.t1, a.dacc, a.wd, a.dres, a.dwd, a.dvec, a.T_len,
                                                  C, a.k);
  LFS2_TRY(cudaGetLastError());
  record(dgrid, dsmem, kDwRows);
  auto ln1_bwd = long_rows ? wide_ln1_bwd_long_kernel<T> : wide_ln1_bwd_kernel<T>;
  LFS2_TRY(opt_in(ln1_bwd, 2 * C * 4));
  ln1_bwd<<<rgrid, 256, 2 * C * 4, s>>>(a.z, a.dres, a.lnp, a.dz, a.dvec, M, C, a.eps);
  LFS2_TRY(cudaGetLastError());
  record(rgrid, 2 * C * 4, kRedRows);
  return cudaSuccess;
}

// both directions take any C a multiple of 128
bool bad_shape(int B, int T_len, int C, int F, int k) {
  return B < 1 || T_len < 1 || C % 128 != 0 || C < 128 || F % 128 != 0 || F < 128 || k < 1 ||
         k > kMaxK;
}

}  // namespace

LFS2_DEFINE_ERROR_STRING

// The forward: z (B, T, C) -> out, both the working dtype; W1^T (F, C) and
// W2f^T (C, F) in it too; wd (k, C), b1 (F), lnp (6, C: g1, be1, g2, be2,
// bd, b2f) f32; t1, h0 (B, T, C), up (B, T, F) the working dtype and ff (B,
// T, C) f32 scratch. drop 0 serves (no dropout, seed unread); 1 trains.
LFS2_EXPORT int lfs2_ffn_wide_fwd(const void* z, void* out, const float* wd, const float* b1,
                                  const float* lnp, const void* w1t, const void* w2ft,
                                  const int* seed, void* t1, void* h0, void* up, float* ff, int B,
                                  int T_len, int C, int F, int k, float eps, unsigned thr,
                                  float ik, int drop, int dtype, void* stream) {
  if (bad_shape(B, T_len, C, F, k)) return static_cast<int>(cudaErrorInvalidValue);
  g_n_rec = 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    Wide<T> a{};
    a.z = static_cast<const T*>(z), a.out = static_cast<T*>(out);
    a.wd = wd, a.b1 = b1, a.lnp = lnp;
    a.w1t = static_cast<const T*>(w1t), a.w2ft = static_cast<const T*>(w2ft), a.seed = seed;
    a.t1 = static_cast<T*>(t1), a.h0 = static_cast<T*>(h0), a.up = static_cast<T*>(up), a.ff = ff;
    a.B = B, a.T_len = T_len, a.C = C, a.F = F, a.k = k, a.eps = eps, a.ik = ik, a.thr = thr;
    a.drop = drop;
    return forward(a, false, s);
  };
  return static_cast<int>(dtype == lfs2::kBF16 ? run(static_cast<bf16*>(nullptr))
                                               : run(static_cast<float*>(nullptr)));
}

// The backward: W1 (C, F) and W2f (F, C) beside their transposes, the
// forward's scratch again, dres and dacc (B, T, C) f32,
// dff (B, T, C) and dup (B, T, F) the working dtype; dz out; dwd (k, C),
// dw1 (C, F), dw2f (F, C), db1 (F) and dvec (6, C: dg1, dbe1, dg2, dbe2,
// dbd, db2f) zeroed f32 buffers the launches add into.
LFS2_EXPORT int lfs2_ffn_wide_bwd(const void* z, const void* dout, const float* wd,
                                  const float* b1, const float* lnp, const void* w1,
                                  const void* w2f, const void* w1t, const void* w2ft,
                                  const int* seed, void* t1, void* h0, void* up,
                                  float* ff, float* dres, void* dff, void* dup, float* dacc,
                                  void* dz, float* dwd, float* dw1, float* dw2f, float* db1,
                                  float* dvec, int B, int T_len, int C, int F, int k, float eps,
                                  unsigned thr, float ik, int dtype, void* stream) {
  if (bad_shape(B, T_len, C, F, k)) return static_cast<int>(cudaErrorInvalidValue);
  g_n_rec = 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    Wide<T> a{};
    a.z = static_cast<const T*>(z), a.dout = static_cast<const T*>(dout);
    a.wd = wd, a.b1 = b1, a.lnp = lnp;
    a.w1 = static_cast<const T*>(w1), a.w2f = static_cast<const T*>(w2f), a.seed = seed;
    a.w1t = static_cast<const T*>(w1t), a.w2ft = static_cast<const T*>(w2ft);
    a.t1 = static_cast<T*>(t1), a.h0 = static_cast<T*>(h0), a.up = static_cast<T*>(up), a.ff = ff;
    a.dres = dres, a.dff = static_cast<T*>(dff), a.dup = static_cast<T*>(dup), a.dacc = dacc;
    a.dz = static_cast<T*>(dz), a.dwd = dwd, a.dw1 = dw1, a.dw2f = dw2f, a.db1 = db1;
    a.dvec = dvec;
    a.B = B, a.T_len = T_len, a.C = C, a.F = F, a.k = k, a.eps = eps, a.ik = ik, a.thr = thr;
    a.drop = 1;
    return backward(a, s);
  };
  return static_cast<int>(dtype == lfs2::kBF16 ? run(static_cast<bf16*>(nullptr))
                                               : run(static_cast<float*>(nullptr)));
}

// out[0]: the latest call's launches n; out[1 + 5 i ..]: launch i's grid (x,
// y, z), dynamic shared memory and rows a block, in launch order
LFS2_EXPORT int lfs2_ffn_wide_last_launches(int* out) {
  out[0] = g_n_rec;
  for (int i = 0; i < g_n_rec; ++i)
    for (int j = 0; j < 5; ++j) out[1 + 5 * i + j] = g_rec[i][j];
  return 0;
}

// ffn_ln_train_bwd: the backward of the training FFN half.
//
// Replaces lightningfastspeech2_tpu/ops/pallas_ffn.py _ffn_train_bwd_kernel
// (fused_ffn_ln_train's backward). Forward, as ffn_ln.cu computes it with
// dropout:
//
//   t1  = LN1(z)  (rows outside [0, T) zeroed, rounded to T)
//   h0  = depthwise_k(t1) + bd                       (rounded)
//   up  = keep1 * round(relu(h0 @ W1 + b1)) / (1-r)  (rounded)
//   ff  = keep2 * (up @ W2f + b2f) / (1-r)
//   out = LN2(t1 + ff)
//
// Given dout the backward writes dz and adds into zeroed f32 buffers dwd
// (k, C), dW1 (C, F), dW2f (F, C), db1 (F) and dvec (6, C) = [dg1, dbe1,
// dg2, dbe2, dbd, db2f]. As the TPU kernel does, dff and dup are rounded
// to the working dtype before their products; every other value and every
// gradient stays f32, and db1, db2f sum the unrounded dup, dff.
//
// What bounds it on an H100: operations, about 2CF x 5 a row (the up
// product again, dup_d, dacc, dW1, dW2f) beside the forward's 2CF x 2.
//
// bf16 route: three launches that share one tile plan (ops/ffn.py
// ffn_plan) and recompute no product on halo rows. The TPU kernel (and the
// CUDA-core code this replaces) recomputed the chain per tile on the k - 1
// rows the depthwise backward reaches, 1.33-1.6x the products a tile
// needs, because it kept everything on chip; here the (T, C) intermediates
// go through device memory (48 MB at the decoder's (8, 2048, 256), most of
// it in L2), and the (T, F) ones, up and dup, stay on chip.
//   (a) chain: ffn_ln.cu's ffn_ln_kernel<CP, true> (the forward with the
//       LN2 backward) writes h0, dres (f32), dff (bf16) and the dg2, dbe2,
//       db2f partials.
//   (b) dup (ffn_dup_kernel, tensor cores): a block owns 128 rows across
//       all of F; per 64-column chunk of F, two warpgroups of 64 rows run
//       up = h0 @ W1c (for the relu mask), dup_d = dff @ W2fc^T,
//       form dup = keep1 relu' dup_d / (1 - r), stage up_d and dup in
//       shared memory, then dacc += dup @ W1c^T (f32 dacc held across F)
//       and, over the tile's 128 rows, dW1[:, c] += h0^T dup and dW2f[c, :]
//       += up_d^T dff, all on the tensor cores from shared memory. W1c and W2fc come from one
//       pre-swizzled image through the producer's two buffers; the
//       transposed products read the same bytes through the descriptors'
//       transpose bits. dacc sums over F in a fixed order, so dz is
//       deterministic; the weight gradients go to device memory with one
//       vector reduction (red.global.add.v4.f32) per four columns, 2 MB a
//       block in all.
//   (c) dt1 (ffn_dt1_kernel, CUDA cores): dt1 = dres + the depthwise
//       backward of dacc, the dwd and dbd partials, LN1 recomputed from z
//       and its backward into dz, dg1 and dbe1.
//
// f32 route (ffn_bwd_kernel, CUDA cores; the tensor cores have no f32
// product): one block recomputes the forward on EP = 32 chain rows and owns
// TT = EP - (k - 1) of them; two passes over F in chunks of 64, the first
// for ff, the second for dup, dacc, dW1 and dW2f (central rows only).
//
// Weight gradients go to one zeroed f32 buffer by atomics, so their
// summation order changes from run to run (f32 order only); dz takes none.
//
// Shapes the kernels take: C in {32, 64, 128, 256}; F a multiple of 64;
// 1 <= k <= 31 in f32 (EP), k <= 63 in bf16 (the forward's t1 window).
#include "common.cuh"
#include "ffn_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFC = 64;  // F columns per chunk

template <typename T> struct Rows;
template <> struct Rows<float> { static constexpr int EP = 32; };

template <typename T> __device__ __forceinline__ void store(T* p, float v) { *p = lfs2::from_f<T>(v); }

struct Args {
  const void* z;
  const void* dout;
  const float* wd;
  const void* w1;
  const void* w1T;
  const float* b1;
  const void* w2f;
  const void* w2fT;
  const float* lnp;
  const int* seed;
  void* dz;
  float* dwd;
  float* dw1;
  float* dw2f;
  float* db1;
  float* dvec;
  int T_len, F, k;
  float eps;
  unsigned threshold;
  float inv_keep;
};

template <int EP, int C>
__host__ __device__ constexpr int smem_bytes_for(int k, int s) {
  return EP * C * 4 + EP * kFC * 4 + 2 * EP * C * s + (EP + k - 1) * C * s + EP * kFC * s;
}

template <typename T, int CN>
__global__ void __launch_bounds__(kThreads)
ffn_bwd_kernel(Args a) {
  constexpr int C = 32 * CN;
  constexpr int EP = Rows<T>::EP;
  constexpr int RW = EP / kWarps;  // chain rows per warp
  const int k = a.k, F = a.F, T_len = a.T_len;
  const int lpad = (k - 1) / 2, rpad = k - 1 - lpad;
  const int TT = EP - (k - 1);
  const int W = EP + k - 1;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int e0 = t0 - rpad;     // global row of chain row 0
  const int w0 = t0 - (k - 1);  // global row of t1 row 0
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* dres = reinterpret_cast<float*>(smem_raw);        // EP x C: res, then dres
  float* dupc = dres + EP * C;                             // EP x kFC: rounded dup chunk
  T* h0s = reinterpret_cast<T*>(dupc + EP * kFC);          // EP x C
  T* dffs = h0s + EP * C;                                  // EP x C
  float* daccs = reinterpret_cast<float*>(h0s);            // EP x C f32 over h0s + dffs, at the end
  T* t1s = dffs + EP * C;                                  // W x C
  T* upc = t1s + W * C;                                    // EP x kFC: up chunk after keep1

  const T* zb = static_cast<const T*>(a.z) + static_cast<size_t>(b) * T_len * C;
  const T* dob = static_cast<const T*>(a.dout) + static_cast<size_t>(b) * T_len * C;
  T* dzb = static_cast<T*>(a.dz) + static_cast<size_t>(b) * T_len * C;
  const T* w1 = static_cast<const T*>(a.w1);
  const T* w1T = static_cast<const T*>(a.w1T);
  const T* w2f = static_cast<const T*>(a.w2f);
  const T* w2fT = static_cast<const T*>(a.w2fT);
  const float* g1 = a.lnp;
  const float* be1 = a.lnp + C;
  const float* g2 = a.lnp + 2 * C;
  const float* bd = a.lnp + 4 * C;
  const float* b2f = a.lnp + 5 * C;
  const unsigned seed_b = lfs2::item_seed(*a.seed, b);
  const float inv_keep = a.inv_keep;

  // 1. LN1 over the t1 window, one warp per row; rows outside [0, T) zero
  for (int r = warp; r < W; r += kWarps) {
    const int g = w0 + r;
    if (g < 0 || g >= T_len) {
#pragma unroll
      for (int i = 0; i < CN; ++i) t1s[r * C + lane + 32 * i] = lfs2::from_f<T>(0.0f);
      continue;
    }
    float v[CN], s = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < CN; ++i) {
      v[i] = lfs2::to_f(zb[static_cast<size_t>(g) * C + lane + 32 * i]);
      s += v[i];
      s2 += v[i] * v[i];
    }
    s = lfs2::warp_sum(s);
    s2 = lfs2::warp_sum(s2);
    const float mean = s / C;
    const float inv = rsqrtf(fmaxf(s2 / C - mean * mean, 0.0f) + a.eps);
#pragma unroll
    for (int i = 0; i < CN; ++i) {
      const int c = lane + 32 * i;
      store(&t1s[r * C + c], (v[i] - mean) * inv * g1[c] + be1[c]);
    }
  }
  __syncthreads();

  // 2. depthwise over the chain rows: h0[e] = sum_j t1[e + j] * wd[j] + bd
  for (int idx = threadIdx.x; idx < EP * C; idx += kThreads) {
    const int e = idx / C, c = idx % C;
    float acc = 0.0f;
    for (int j = 0; j < k; ++j) acc += lfs2::to_f(t1s[(e + j) * C + c]) * a.wd[j * C + c];
    store(&h0s[idx], acc + bd[c]);
  }
  __syncthreads();

  const int row0 = warp * RW;   // this warp's chain rows
  const int c0 = lane * CN;     // this lane's columns of a C-wide row
  const int fl = lane * 2;      // this lane's columns of an F chunk

  // 3. pass 1: ff over the chain rows
  float acc[RW][CN];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.0f;
  for (int f0 = 0; f0 < F; f0 += kFC) {
    float u[RW][2];
#pragma unroll
    for (int i = 0; i < RW; ++i) u[i][0] = u[i][1] = 0.0f;
#pragma unroll 4
    for (int ci = 0; ci < C; ++ci) {
      float wv[2];
      lfs2::load_vec<2>(w1 + static_cast<size_t>(ci) * F + f0 + fl, wv);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float hv = lfs2::to_f(h0s[(row0 + i) * C + ci]);
        u[i][0] += hv * wv[0];
        u[i][1] += hv * wv[1];
      }
    }
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int f = f0 + fl + j;
        float v = lfs2::round_to<T>(fmaxf(u[i][j] + a.b1[f], 0.0f));
        const bool keep = lfs2::ffn_keep(e0 + row0 + i, f, seed_b, 1u, a.threshold);
        store(&upc[(row0 + i) * kFC + fl + j], keep ? v * inv_keep : 0.0f);
      }
    __syncthreads();
#pragma unroll 4
    for (int f = 0; f < kFC; ++f) {
      float wv[CN];
      lfs2::load_vec<CN>(w2f + static_cast<size_t>(f0 + f) * C + c0, wv);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float uv = lfs2::to_f(upc[(row0 + i) * kFC + f]);
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] += uv * wv[j];
      }
    }
    __syncthreads();
  }

  // 4. residual on the LN1 output: res[e] = t1[e + lpad] + keep2 * ff / (1-r)
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int e = row0 + i, c = c0 + j;
      const float ff = acc[i][j] + b2f[c];
      const bool keep = lfs2::ffn_keep(e0 + e, c, seed_b, 2u, a.threshold);
      dres[e * C + c] = lfs2::to_f(t1s[(e + lpad) * C + c]) + (keep ? ff * inv_keep : 0.0f);
    }
  __syncthreads();

  // 5. LN2 backward per chain row (warp per row): dres, and dff rounded for
  //    the products; dg2, dbe2 and db2f over the central rows
  float vg2[CN], vbe2[CN], vb2f[CN];
#pragma unroll
  for (int i = 0; i < CN; ++i) vg2[i] = vbe2[i] = vb2f[i] = 0.0f;
  for (int e = warp; e < EP; e += kWarps) {
    const int g = e0 + e;
    const bool in_t = g >= 0 && g < T_len;
    const bool central = e >= rpad && e < rpad + TT;
    float x[CN], dy[CN], s = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < CN; ++i) {
      const int c = lane + 32 * i;
      x[i] = dres[e * C + c];
      dy[i] = in_t ? lfs2::to_f(dob[static_cast<size_t>(g) * C + c]) : 0.0f;
      s += x[i];
      s2 += x[i] * x[i];
    }
    s = lfs2::warp_sum(s);
    s2 = lfs2::warp_sum(s2);
    const float mean = s / C;
    const float inv = rsqrtf(fmaxf(s2 / C - mean * mean, 0.0f) + a.eps);
    float m1 = 0.0f, m2 = 0.0f;
#pragma unroll
    for (int i = 0; i < CN; ++i) {
      x[i] = (x[i] - mean) * inv;  // x_hat
      const float dyg = dy[i] * g2[lane + 32 * i];
      m1 += dyg;
      m2 += dyg * x[i];
    }
    m1 = lfs2::warp_sum(m1) / C;
    m2 = lfs2::warp_sum(m2) / C;
#pragma unroll
    for (int i = 0; i < CN; ++i) {
      const int c = lane + 32 * i;
      const float dr = inv * (dy[i] * g2[c] - m1 - x[i] * m2);
      dres[e * C + c] = dr;
      const float dff = lfs2::ffn_keep(g, c, seed_b, 2u, a.threshold) ? dr * inv_keep : 0.0f;
      store(&dffs[e * C + c], dff);
      if (central) {
        vg2[i] += dy[i] * x[i];
        vbe2[i] += dy[i];
        vb2f[i] += dff;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < CN; ++i) {
    const int c = lane + 32 * i;
    atomicAdd(&a.dvec[2 * C + c], vg2[i]);
    atomicAdd(&a.dvec[3 * C + c], vbe2[i]);
    atomicAdd(&a.dvec[5 * C + c], vb2f[i]);
  }
  __syncthreads();

  // 6. pass 2 over F chunks: recompute up, form dup, accumulate dacc, and
  //    add the chunk's dW1 / dW2f / db1 over the central rows
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.0f;  // now dacc
  for (int f0 = 0; f0 < F; f0 += kFC) {
    float u[RW][2], d[RW][2];
#pragma unroll
    for (int i = 0; i < RW; ++i) u[i][0] = u[i][1] = d[i][0] = d[i][1] = 0.0f;
#pragma unroll 2
    for (int ci = 0; ci < C; ++ci) {
      float wv[2], wt[2];
      lfs2::load_vec<2>(w1 + static_cast<size_t>(ci) * F + f0 + fl, wv);
      lfs2::load_vec<2>(w2fT + static_cast<size_t>(ci) * F + f0 + fl, wt);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float hv = lfs2::to_f(h0s[(row0 + i) * C + ci]);
        const float dv = lfs2::to_f(dffs[(row0 + i) * C + ci]);
        u[i][0] += hv * wv[0];
        u[i][1] += hv * wv[1];
        d[i][0] += dv * wt[0];
        d[i][1] += dv * wt[1];
      }
    }
    float vb1[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = row0 + i, f = f0 + fl + j;
        const float pre = u[i][j] + a.b1[f];
        const float v = lfs2::round_to<T>(fmaxf(pre, 0.0f));
        const bool keep = lfs2::ffn_keep(e0 + e, f, seed_b, 1u, a.threshold);
        store(&upc[e * kFC + fl + j], keep ? v * inv_keep : 0.0f);
        const float dup = (keep && pre > 0.0f) ? d[i][j] * inv_keep : 0.0f;
        dupc[e * kFC + fl + j] = lfs2::round_to<T>(dup);
        if (e >= rpad && e < rpad + TT) vb1[j] += dup;
      }
    atomicAdd(&a.db1[f0 + fl], vb1[0]);
    atomicAdd(&a.db1[f0 + fl + 1], vb1[1]);
    __syncthreads();

    // dacc += dup (EP x kFC) @ W1T[f0:f0+kFC, :]
#pragma unroll 4
    for (int f = 0; f < kFC; ++f) {
      float wv[CN];
      lfs2::load_vec<CN>(w1T + static_cast<size_t>(f0 + f) * C + c0, wv);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float dv = dupc[(row0 + i) * kFC + f];
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] += dv * wv[j];
      }
    }

    // dW1[c, f0 + f] += sum_central h0[e, c] * dup[e, f]: warp w owns
    // C / 8 rows of c in four passes of CN, lane owns two f
    for (int q = 0; q < 4; ++q) {
      const int cb = warp * 4 * CN + q * CN;
      float pw[CN][2];
#pragma unroll
      for (int i = 0; i < CN; ++i) pw[i][0] = pw[i][1] = 0.0f;
      for (int e = rpad; e < rpad + TT; ++e) {
        const float d0 = dupc[e * kFC + fl], d1 = dupc[e * kFC + fl + 1];
#pragma unroll
        for (int i = 0; i < CN; ++i) {
          const float hv = lfs2::to_f(h0s[e * C + cb + i]);
          pw[i][0] += hv * d0;
          pw[i][1] += hv * d1;
        }
      }
#pragma unroll
      for (int i = 0; i < CN; ++i) {
        atomicAdd(&a.dw1[static_cast<size_t>(cb + i) * F + f0 + fl], pw[i][0]);
        atomicAdd(&a.dw1[static_cast<size_t>(cb + i) * F + f0 + fl + 1], pw[i][1]);
      }
    }

    // dW2f[f0 + f, c] += sum_central up[e, f] * dff[e, c]: warp w owns 8
    // rows of f in four passes of 2, lane owns CN columns
    for (int q = 0; q < 4; ++q) {
      const int fb = warp * 8 + q * 2;
      float pw[2][CN];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) pw[i][j] = 0.0f;
      for (int e = rpad; e < rpad + TT; ++e) {
        float dv[CN];
        lfs2::load_vec<CN>(dffs + e * C + c0, dv);
        const float u0 = lfs2::to_f(upc[e * kFC + fb]), u1 = lfs2::to_f(upc[e * kFC + fb + 1]);
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          pw[0][j] += u0 * dv[j];
          pw[1][j] += u1 * dv[j];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j)
          atomicAdd(&a.dw2f[static_cast<size_t>(f0 + fb + i) * C + c0 + j], pw[i][j]);
    }
    __syncthreads();
  }

  // 7. dacc to shared memory, over h0 and dff (no longer read)
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) daccs[(row0 + i) * C + c0 + j] = acc[i][j];
  __syncthreads();

  // 8. dwd[j, c] = sum_central t1[e + j, c] * dacc[e, c]; dbd = sum dacc
  for (int idx = threadIdx.x; idx < (k + 1) * C; idx += kThreads) {
    const int j = idx / C, c = idx % C;
    float s = 0.0f;
    if (j < k) {
      for (int e = rpad; e < rpad + TT; ++e) s += lfs2::to_f(t1s[(e + j) * C + c]) * daccs[e * C + c];
      atomicAdd(&a.dwd[j * C + c], s);
    } else {
      for (int e = rpad; e < rpad + TT; ++e) s += daccs[e * C + c];
      atomicAdd(&a.dvec[4 * C + c], s);
    }
  }

  // 9. central rows: dt1 = dres + depthwise backward of dacc, then the LN1
  //    backward into dz; dg1 and dbe1
  float vg1[CN], vbe1[CN];
#pragma unroll
  for (int i = 0; i < CN; ++i) vg1[i] = vbe1[i] = 0.0f;
  for (int r = warp; r < TT; r += kWarps) {
    const int g = t0 + r;
    if (g >= T_len) break;
    float dt[CN], x[CN], s = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < CN; ++i) {
      const int c = lane + 32 * i;
      float v = dres[(r + rpad) * C + c];
      for (int j = 0; j < k; ++j) v += daccs[(r + k - 1 - j) * C + c] * a.wd[j * C + c];
      dt[i] = v;
      x[i] = lfs2::to_f(zb[static_cast<size_t>(g) * C + c]);
      s += x[i];
      s2 += x[i] * x[i];
    }
    s = lfs2::warp_sum(s);
    s2 = lfs2::warp_sum(s2);
    const float mean = s / C;
    const float inv = rsqrtf(fmaxf(s2 / C - mean * mean, 0.0f) + a.eps);
    float m1 = 0.0f, m2 = 0.0f;
#pragma unroll
    for (int i = 0; i < CN; ++i) {
      x[i] = (x[i] - mean) * inv;
      const float dyg = dt[i] * g1[lane + 32 * i];
      m1 += dyg;
      m2 += dyg * x[i];
    }
    m1 = lfs2::warp_sum(m1) / C;
    m2 = lfs2::warp_sum(m2) / C;
#pragma unroll
    for (int i = 0; i < CN; ++i) {
      const int c = lane + 32 * i;
      store(&dzb[static_cast<size_t>(g) * C + c], inv * (dt[i] * g1[c] - m1 - x[i] * m2));
      vg1[i] += dt[i] * x[i];
      vbe1[i] += dt[i];
    }
  }
#pragma unroll
  for (int i = 0; i < CN; ++i) {
    const int c = lane + 32 * i;
    atomicAdd(&a.dvec[c], vg1[i]);
    atomicAdd(&a.dvec[C + c], vbe1[i]);
  }
}

// the launches of the latest accepted call: per launch grid x, y, z,
// shared-memory bytes a block and rows of one item a block owns (the f32
// route's one launch, or the bf16 route's dup and dt1 passes)
int g_last_launch[2][5];

cudaError_t record_launch(int which, const dim3& grid, int smem, int rows) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    if (which == 0)
      for (int i = 0; i < 5; ++i) g_last_launch[1][i] = 0;
    g_last_launch[which][0] = grid.x;
    g_last_launch[which][1] = grid.y;
    g_last_launch[which][2] = grid.z;
    g_last_launch[which][3] = smem;
    g_last_launch[which][4] = rows;
  }
  return err;
}

template <typename T, int CN>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int C = 32 * CN;
  constexpr int EP = Rows<T>::EP;
  if (a.k < 1 || a.k > EP - 1) return cudaErrorInvalidValue;
  const int smem = smem_bytes_for<EP, C>(a.k, static_cast<int>(sizeof(T)));
  auto kernel = ffn_bwd_kernel<T, CN>;
  cudaError_t err = lfs2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int TT = EP - (a.k - 1);
  const dim3 grid((a.T_len + TT - 1) / TT, B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return record_launch(0, grid, smem, TT);
}

cudaError_t f32_dispatch(int C, const Args& a, int B, cudaStream_t s) {
  switch (C) {
    case 32: return launch<float, 1>(a, B, s);
    case 64: return launch<float, 2>(a, B, s);
    case 128: return launch<float, 4>(a, B, s);
    case 256: return launch<float, 8>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// ============================ bf16 route ====================================
using ffn::bf16;

// value e of an accumulator block: row 0 (e < 2) or 8, column + (e & 1)
__device__ __forceinline__ float pick(float2 v, int e) { return (e & 1) ? v.y : v.x; }

struct DupArgs {
  const bf16* h0;      // (B, T, C), from the chain
  const bf16* dff;     // (B, T, C)
  const uint8_t* img;  // the weight image (ops/ffn.py _weight_image)
  const float* b1;
  const int* seed;
  float* dacc;         // (B, T, C) out
  float* dw1;
  float* dw2f;
  float* db1;
  int T, C, F;
  unsigned threshold;
  float inv_keep;
};

// (b): named barriers 1 + w (warpgroup w has written its up and dup rows
// of the chunk), 3 + w (warpgroup w no longer reads either staging) and
// 5 + w (warpgroup w's own rows are staged). Block b walks the F chunks
// from chunk b on, so that the blocks' weight-gradient reductions spread
// over the matrices instead of meeting on one chunk.
template <int CP>
__global__ void __launch_bounds__(ffn::kThreads, 1)
ffn_dup_kernel(const __grid_constant__ DupArgs a) {
  using namespace ffn;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const int C = a.C, T = a.T, F = a.F;
  const uint32_t base = smem_u32(smem);
  const uint32_t w1s = base, w2s = base + wbuf_bytes(CP);
  const uint32_t h0s = w2s + wbuf_bytes(CP), dffs = h0s + tile_bytes(CP);
  const uint32_t ups = dffs + tile_bytes(CP), dups = ups + stage_bytes();
  uint8_t* upp = smem + (ups - base);
  uint8_t* dupp = smem + (dups - base);
  const Bars bars(dups + stage_bytes(),
                  reinterpret_cast<uint32_t*>(dupp + stage_bytes() + 16));
  const int b = blockIdx.y, t0 = blockIdx.x * kRows, nchunks = F / kFC;
  const int rot = (blockIdx.x + blockIdx.y * gridDim.x) % nchunks;
  FFN_CLOCK(tp);

  if (threadIdx.x == 0) {
    bars.init();
    load_w(bars, 0, w1s, a.img, rot, CP);
    load_w(bars, 1, w2s, a.img, rot, CP);
  }
  // the tile's h0 and dff rows into the swizzled tiles; zero beyond T and C
  {
    constexpr int pieces = CP / 8;
    const size_t off = (static_cast<size_t>(b) * T + t0) * C;
    for (int idx = threadIdx.x; idx < kRows * pieces; idx += ffn::kThreads) {
      const int r = idx / pieces, c = 8 * (idx % pieces), o = swz(r, c, kRows);
      if (t0 + r < T && c < C) {
        cp_async16(h0s + o, a.h0 + off + static_cast<size_t>(r) * C + c);
        cp_async16(dffs + o, a.dff + off + static_cast<size_t>(r) * C + c);
      } else {
        *reinterpret_cast<uint4*>(smem + (h0s - base) + o) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(smem + (dffs - base) + o) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_wait_all();
  }
  fence_proxy_async();
  __syncthreads();
  FFN_PHASE(0, tp);  // prologue

  const int cw = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int rl = 64 * cw + 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
  const int c2 = 2 * (lane & 3);
  const bool drop = a.threshold != 0u;
  const unsigned seed_b = lfs2::item_seed(*a.seed, b), thr = a.threshold;
  const float ik = a.inv_keep;
  const unsigned rh[2] = {row_hash(t0 + rl), row_hash(t0 + rl + 8)};
  float dacc[CP / 2];
#pragma unroll
  for (int i = 0; i < CP / 2; ++i) dacc[i] = 0.0f;

  for (int i = 0; i < nchunks; ++i) {
    const unsigned ph = i & 1;
    const int f0 = ((i + rot) % nchunks) * kFC;
    const int next = i + 1 < nchunks ? (i + 1 + rot) % nchunks : -1;
    // up again (the relu and keep1 bits, and up_d for dW2f)
    unsigned bits = 0u;
    {
      float2 bb[8];  // b1 of the thread's columns, loaded while the product runs
#pragma unroll
      for (int j = 0; j < 8; ++j) bb[j] = *reinterpret_cast<const float2*>(a.b1 + f0 + 8 * j + c2);
      float up[32];
      mbar_wait(bars.full1, ph);
      FFN_PHASE(1, tp);  // waiting for W1
      wgmma_fence();
      {
        const uint32_t h0d = opaque(desc(h0s)), w1d = opaque(desc(w1s));
#pragma unroll
        for (int kk = 0; kk < CP / 16; ++kk)
          SsOp<64>::run<0, 1>(up, kmajor(h0d, kRows, 64 * cw, kk), mnmajor(w1d, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      hold(up);
      FFN_PHASE(2, tp);  // up product
      if (i > 0) named_sync(3 + (1 - cw));  // the other warpgroup is done with the stagings
      FFN_PHASE(3, tp);  // waiting for the other warpgroup's dW
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int f = f0 + 8 * j + c2;
        float ud[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pre = up[4 * j + e] + pick(bb[j], e);
          const bool keep = !drop || keep_h(rh[e >> 1], col_hash(f + (e & 1), 1u), seed_b, thr);
          ud[e] = keep ? lfs2::round_to<bf16>(fmaxf(pre, 0.0f)) * ik : 0.0f;
          if (keep && pre > 0.0f) bits |= 1u << (4 * j + e);
        }
        stage_pair(upp, rl, 8 * j + c2, ud[0], ud[1]);
        stage_pair(upp, rl + 8, 8 * j + c2, ud[2], ud[3]);
      }
    }
    FFN_PHASE(4, tp);  // up epilogue
    // dup_d = dff @ W2fc^T; dup = keep1 relu' dup_d / (1 - r), rounded into
    // the dup staging; db1 sums it unrounded
    {
      float dd[32];
      mbar_wait(bars.full2, ph);
      FFN_PHASE(5, tp);  // waiting for W2
      wgmma_fence();
      {
        const uint32_t dffd = opaque(desc(dffs)), w2d = opaque(desc(w2s));
#pragma unroll
        for (int kk = 0; kk < CP / 16; ++kk)
          SsOp<64>::run<0, 0>(dd, kmajor(dffd, kRows, 64 * cw, kk), kmajor(w2d, 64, 0, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      hold(dd);
      FFN_PHASE(6, tp);  // dup_d product
      release_w(bars, 1, w2s, a.img, next, CP);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float dv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) dv[e] = (bits >> (4 * j + e)) & 1u ? dd[4 * j + e] * ik : 0.0f;
        stage_pair(dupp, rl, 8 * j + c2, dv[0], dv[1]);
        stage_pair(dupp, rl + 8, 8 * j + c2, dv[2], dv[3]);
        add_col_pair(a.db1 + f0 + 8 * j + c2, dv[0] + dv[2], dv[1] + dv[3], lane);
      }
    }
    fence_proxy_async();
    wg_sync(5 + cw);  // the warpgroup's rows of both stagings are in place
    named_arrive(1 + cw);
    FFN_PHASE(7, tp);  // dup epilogue
    // dacc += dup @ W1c^T
    wgmma_fence();
    {
      const uint32_t sd = opaque(desc(dups)), w1d = opaque(desc(w1s));
#pragma unroll
      for (int s = 0; s < 4; ++s)
        SsOp<CP>::template run<0, 0>(dacc, kmajor(sd, kRows, 64 * cw, s), kmajor(w1d, CP, 0, s), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    hold(dacc);
    FFN_PHASE(8, tp);  // dacc product
    release_w(bars, 0, w1s, a.img, next, CP);
    named_sync(1 + (1 - cw));  // both warpgroups' rows are staged
    FFN_PHASE(9, tp);  // waiting for the other warpgroup's staging
    // the chunk's weight gradients over the tile's 128 rows, 64 x 64 pieces:
    // dW1[c-box p, chunk] = h0^T dup, dW2f[chunk, c-box q] = up_d^T dff
    for (int p = cw; p < 2 * (CP / 64); p += 2) {
      float acc[32];
      const bool w1p = p < CP / 64;
      const int q = w1p ? p : p - CP / 64;
      const uint32_t da = opaque(desc(w1p ? h0s + q * kRows * 128 : ups));
      const uint32_t db = opaque(desc(w1p ? dups : dffs + q * kRows * 128));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
        SsOp<64>::run<1, 1>(acc, mnmajor(da, kk), mnmajor(db, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      hold(acc);
      FFN_PHASE(10, tp);  // weight-gradient products
      if (w1p)
        add_tile(a.dw1, F, acc, 64 * q, f0, lane, C, F);
      else
        add_tile(a.dw2f, C, acc, f0, 64 * q, lane, F, C);
      FFN_PHASE(11, tp);  // weight-gradient reductions
    }
    if (i + 1 < nchunks) named_arrive(3 + cw);
  }

  const size_t row0 = static_cast<size_t>(b) * T + t0 + rl;
#pragma unroll
  for (int j = 0; j < CP / 8; ++j) {
    const int c = 8 * j + c2;
    if (c >= C) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (t0 + rl + 8 * h < T)
        *reinterpret_cast<float2*>(a.dacc + (row0 + 8 * h) * C + c) =
            make_float2(dacc[4 * j + 2 * h], dacc[4 * j + 2 * h + 1]);
  }
  FFN_PHASE(12, tp);  // dacc store
  FFN_FLUSH();
}

struct Dt1Args {
  const bf16* z;
  const float* dres;
  const float* dacc;
  const float* wd;
  const float* lnp;
  bf16* dz;
  float* dwd;
  float* dvec;
  int T, k;
  float eps;
};

// (c): a block owns kDt1Rows rows of one item; dacc over them and the k - 1
// rows the depthwise backward reaches (f32), t1 over the rows the dwd sums
// reach (recomputed from z and rounded, as the forward formed it)
template <int CN>
__global__ void __launch_bounds__(ffn::kDt1Threads)
ffn_dt1_kernel(const __grid_constant__ Dt1Args a) {
  constexpr int C = 32 * CN, TC = ffn::kDt1Rows, NW = ffn::kDt1Threads / 32, RPW = TC / NW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = a.k, T = a.T, lpad = (k - 1) / 2, rpad = k - 1 - lpad, Wn = TC + k - 1;
  float* dw = reinterpret_cast<float*>(smem_raw);      // dacc rows t0 - rpad ..
  bf16* t1w = reinterpret_cast<bf16*>(dw + Wn * C);    // t1 rows t0 - lpad ..
  const int b = blockIdx.y, t0 = blockIdx.x * TC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t base = static_cast<size_t>(b) * T * C;
  const float* g1 = a.lnp;
  const float* be1 = a.lnp + C;

  for (int idx = threadIdx.x; idx < Wn * C / 4; idx += ffn::kDt1Threads) {
    const int r = idx / (C / 4), c = 4 * (idx % (C / 4)), g = t0 - rpad + r;
    *reinterpret_cast<float4*>(dw + r * C + c) =
        g >= 0 && g < T ? *reinterpret_cast<const float4*>(a.dacc + base + static_cast<size_t>(g) * C + c)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (int r = warp; r < Wn; r += NW) {
    const int g = t0 - lpad + r;
    const bool in = g >= 0 && g < T;
    float v[CN], s = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < CN; ++i) {
      v[i] = in ? lfs2::to_f(a.z[base + static_cast<size_t>(g) * C + lane + 32 * i]) : 0.0f;
      s += v[i];
      s2 += v[i] * v[i];
    }
    s = lfs2::warp_sum(s);
    s2 = lfs2::warp_sum(s2);
    const float mean = s / C;
    const float inv = rsqrtf(fmaxf(s2 / C - mean * mean, 0.0f) + a.eps);
#pragma unroll
    for (int i = 0; i < CN; ++i) {
      const int c = lane + 32 * i;
      t1w[r * C + c] = lfs2::from_f<bf16>(in ? ffn::ln_apply(v[i], mean, inv, g1[c], be1[c]) : 0.0f);
    }
  }
  __syncthreads();

  // dwd[j, c] = sum_e t1[e + j - lpad, c] dacc[e, c] and dbd over the own
  // rows e (dacc is zero on rows >= T), four channels a thread
  for (int idx = threadIdx.x; idx < (k + 1) * (C / 4); idx += ffn::kDt1Threads) {
    const int j = idx / (C / 4), c = 4 * (idx % (C / 4));
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int r = 0; r < TC; ++r) {
      const float4 d = *reinterpret_cast<const float4*>(dw + (r + rpad) * C + c);
      float4 t = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
      if (j < k) {
        const uint2 raw = *reinterpret_cast<const uint2*>(t1w + (r + j) * C + c);
        const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        t = make_float4(lo.x, lo.y, hi.x, hi.y);
      }
      s.x += t.x * d.x;
      s.y += t.y * d.y;
      s.z += t.z * d.z;
      s.w += t.w * d.w;
    }
    atomicAdd(reinterpret_cast<float4*>(j < k ? a.dwd + j * C + c : a.dvec + 4 * C + c), s);
  }

  // own rows, RPW a warp: dt1 = dres + the depthwise backward of dacc (the
  // taps read once for the warp's rows), then the LN1 backward into dz;
  // dg1 and dbe1
  const int r0 = warp * RPW;
  float dt[RPW][CN];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr)
#pragma unroll
    for (int i = 0; i < CN; ++i) dt[rr][i] = 0.0f;
  for (int j = 0; j < k; ++j) {
    float wv[CN];
#pragma unroll
    for (int i = 0; i < CN; ++i) wv[i] = a.wd[j * C + lane + 32 * i];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr)
#pragma unroll
      for (int i = 0; i < CN; ++i) dt[rr][i] += dw[(r0 + rr + k - 1 - j) * C + lane + 32 * i] * wv[i];
  }
  float vg1[CN], vbe1[CN];
#pragma unroll
  for (int i = 0; i < CN; ++i) vg1[i] = vbe1[i] = 0.0f;
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int g = t0 + r0 + rr;
    if (g >= T) break;
    const size_t o = base + static_cast<size_t>(g) * C;
    float x[CN], s = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < CN; ++i) {
      const int c = lane + 32 * i;
      dt[rr][i] += a.dres[o + c];
      x[i] = lfs2::to_f(a.z[o + c]);
      s += x[i];
      s2 += x[i] * x[i];
    }
    s = lfs2::warp_sum(s);
    s2 = lfs2::warp_sum(s2);
    const float mean = s / C;
    const float inv = rsqrtf(fmaxf(s2 / C - mean * mean, 0.0f) + a.eps);
    float m1 = 0.0f, m2 = 0.0f;
#pragma unroll
    for (int i = 0; i < CN; ++i) {
      x[i] = (x[i] - mean) * inv;
      const float dyg = dt[rr][i] * g1[lane + 32 * i];
      m1 += dyg;
      m2 += dyg * x[i];
    }
    m1 = lfs2::warp_sum(m1) / C;
    m2 = lfs2::warp_sum(m2) / C;
#pragma unroll
    for (int i = 0; i < CN; ++i) {
      const int c = lane + 32 * i;
      a.dz[o + c] = lfs2::from_f<bf16>(inv * (dt[rr][i] * g1[c] - m1 - x[i] * m2));
      vg1[i] += dt[rr][i] * x[i];
      vbe1[i] += dt[rr][i];
    }
  }
#pragma unroll
  for (int i = 0; i < CN; ++i) {
    const int c = lane + 32 * i;
    atomicAdd(&a.dvec[c], vg1[i]);
    atomicAdd(&a.dvec[C + c], vbe1[i]);
  }
}

template <int CP>
cudaError_t dup_launch(const DupArgs& a, int B, cudaStream_t s) {
  const int smem = ffn::dup_smem(CP);
  auto kernel = ffn_dup_kernel<CP>;
  cudaError_t err = lfs2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + ffn::kRows - 1) / ffn::kRows, B);
  kernel<<<grid, ffn::kThreads, smem, s>>>(a);
  return record_launch(0, grid, smem, ffn::kRows);
}

template <int CN>
cudaError_t dt1_launch(const Dt1Args& a, int B, cudaStream_t s) {
  const int smem = ffn::dt1_smem(32 * CN, a.k);
  if (smem > ffn::kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = ffn_dt1_kernel<CN>;
  cudaError_t err = lfs2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + ffn::kDt1Rows - 1) / ffn::kDt1Rows, B);
  kernel<<<grid, ffn::kDt1Threads, smem, s>>>(a);
  return record_launch(1, grid, smem, ffn::kDt1Rows);
}

cudaError_t bf16_backward(int C, const DupArgs& d, const Dt1Args& t, int B, cudaStream_t s) {
  cudaError_t err;
  switch (C) {
    case 32:
    case 64: err = dup_launch<64>(d, B, s); break;
    case 128: err = dup_launch<128>(d, B, s); break;
    case 256: err = dup_launch<256>(d, B, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  switch (C) {
    case 32: return dt1_launch<1>(t, B, s);
    case 64: return dt1_launch<2>(t, B, s);
    case 128: return dt1_launch<4>(t, B, s);
    default: return dt1_launch<8>(t, B, s);
  }
}

}  // namespace

LFS2_DEFINE_ERROR_STRING

// The f32 route. dwd, dw1, dw2f, db1 and dvec must be zeroed f32 buffers;
// seed is one int32 on the device
LFS2_EXPORT int lfs2_ffn_ln_train_bwd(const void* z, const void* dout, const float* wd,
                                      const void* w1, const void* w1T, const float* b1,
                                      const void* w2f, const void* w2fT, const float* lnp,
                                      const int* seed, void* dz, float* dwd, float* dw1,
                                      float* dw2f, float* db1, float* dvec, int B, int T_len,
                                      int C, int F, int k, float eps, unsigned threshold,
                                      float inv_keep, void* stream) {
  if (F % kFC != 0 || B < 1 || T_len < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{z, dout, wd, w1, w1T, b1, w2f, w2fT, lnp, seed, dz, dwd, dw1, dw2f, db1, dvec,
               T_len, F, k, eps, threshold, inv_keep};
  return static_cast<int>(f32_dispatch(C, a, B, static_cast<cudaStream_t>(stream)));
}

// The bf16 route's stages (b) and (c), after ffn_ln.cu's lfs2_ffn_ln_chain
// wrote h0, dres and dff (and dg2, dbe2, db2f into dvec). dacc is (B, T, C)
// f32 scratch; dwd, dw1, dw2f, db1 and dvec are zeroed f32 buffers
LFS2_EXPORT int lfs2_ffn_ln_train_bwd_bf16(const void* z, const float* dres, const void* h0,
                                           const void* dff, const float* wd, const void* img,
                                           const float* b1, const float* lnp, const int* seed,
                                           float* dacc, void* dz, float* dwd, float* dw1,
                                           float* dw2f, float* db1, float* dvec, int B, int T_len,
                                           int C, int F, int k, float eps, unsigned threshold,
                                           float inv_keep, void* stream) {
  if (F % kFC != 0 || B < 1 || T_len < 1 || k < 1 || k > ffn::kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  DupArgs d{};
  d.h0 = static_cast<const bf16*>(h0);
  d.dff = static_cast<const bf16*>(dff);
  d.img = static_cast<const uint8_t*>(img);
  d.b1 = b1;
  d.seed = seed;
  d.dacc = dacc;
  d.dw1 = dw1;
  d.dw2f = dw2f;
  d.db1 = db1;
  d.T = T_len;
  d.C = C;
  d.F = F;
  d.threshold = threshold;
  d.inv_keep = inv_keep;
  const Dt1Args t{static_cast<const bf16*>(z), dres, dacc, wd, lnp, static_cast<bf16*>(dz), dwd,
                  dvec, T_len, k, eps};
  return static_cast<int>(bf16_backward(C, d, t, B, static_cast<cudaStream_t>(stream)));
}

#ifdef LFS2_FFN_PHASE_CLOCKS
// copies out and zeroes block (0, 0)'s phase cycles, [warpgroup][slot]
LFS2_EXPORT int lfs2_ffn_dup_phase_clocks(long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, ffn::g_phase, sizeof(ffn::g_phase));
  static const long long zero[2][16] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(ffn::g_phase, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif

// copies into out[0..9] the grid (x, y, z), shared-memory bytes and rows of
// the latest accepted call's launches (the second zero on the f32 route)
LFS2_EXPORT int lfs2_ffn_ln_train_bwd_last_launches(int* out) {
  for (int i = 0; i < 10; ++i) out[i] = g_last_launch[i / 5][i % 5];
  return 0;
}

// ffn_ln_train_bwd: the backward of the training FFN half, recomputing the
// forward per tile.
//
// Replaces lightningfastspeech2_tpu/ops/pallas_ffn.py _ffn_train_bwd_kernel
// (fused_ffn_ln_train's backward). Forward, as ffn_ln.cu computes it with
// kTrain:
//
//   t1  = LN1(z)  (rows outside [0, T) zeroed, rounded to T)
//   h0  = depthwise_k(t1) + bd                       (rounded)
//   up  = keep1 * round(relu(h0 @ W1 + b1)) / (1-r)  (rounded)
//   ff  = keep2 * (up @ W2f + b2f) / (1-r)
//   out = LN2(t1 + ff)
//
// Given dout this kernel writes dz and adds into zeroed f32 buffers dwd
// (k, C), dW1 (C, F), dW2f (F, C), db1 (F) and dvec (6, C) = [dg1, dbe1,
// dg2, dbe2, dbd, db2f].
//
// Tiling. A block owns TT = EP - (k - 1) output rows [t0, t0 + TT) of one
// batch item. The depthwise backward needs dacc on rows out to -(k-1-lpad)
// and +lpad around them, so the FFN chain is recomputed on EP = TT + k - 1
// rows e0 = t0 - (k-1-lpad) ...; those need t1 on EP + k - 1 rows from
// t0 - (k - 1). The halos are exact (the TPU's 16-row rounding was a sublane
// artifact). F is too wide to keep, so two passes run over F in chunks of
// 64: pass 1 recomputes ff to get the residual and the LN2 backward; pass 2
// recomputes up per chunk, forms dup, and accumulates dacc (registers),
// dW1 and dW2f (central rows only, each row owned by one block).
//
// Weight gradients: every block adds its tile's (C, F) and (F, C) partials
// into one f32 buffer with atomicAdd (red.global.add.f32). The TPU design
// wrote per-tile partials and summed them outside; here, at the decoder's
// (8, 2048, 256) with ~44-row tiles, per-tile partials would be 372 tiles
// x 2 MB = 0.7 GB of writes plus a reduction pass, while the atomics move
// the same bytes into a 2 MB buffer that stays in the 50 MB L2. The order
// of the additions changes from run to run, so the weight gradients are
// not bitwise reproducible (f32 summation order only).
//
// What bounds it on an H100: operations. Per row the chain costs about
// 2CF x (2 recomputes + 3 backward products) plus the weight products;
// like ffn_ln.cu the products are plain f32 FMAs on the CUDA cores (simple
// first), with every intermediate kept in shared memory or registers.
// Tensor cores are the next step.
//
// Shapes the kernel takes: C = 32 * CN, CN in {1, 2, 4, 8}; F a multiple of
// 64; 1 <= k <= EP - 1 with EP = 64 in bf16 and 32 in f32 (shared memory).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFC = 64;  // F columns per chunk

template <typename T> struct Rows;
template <> struct Rows<float> { static constexpr int EP = 32; };
template <> struct Rows<__nv_bfloat16> { static constexpr int EP = 64; };

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
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int C, const Args& a, int B, cudaStream_t s) {
  switch (C) {
    case 32: return launch<T, 1>(a, B, s);
    case 64: return launch<T, 2>(a, B, s);
    case 128: return launch<T, 4>(a, B, s);
    case 256: return launch<T, 8>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

LFS2_DEFINE_ERROR_STRING

// dwd, dw1, dw2f, db1 and dvec must be zeroed f32 buffers; seed is one
// int32 on the device
LFS2_EXPORT int lfs2_ffn_ln_train_bwd(const void* z, const void* dout, const float* wd,
                                      const void* w1, const void* w1T, const float* b1,
                                      const void* w2f, const void* w2fT, const float* lnp,
                                      const int* seed, void* dz, float* dwd, float* dw1,
                                      float* dw2f, float* db1, float* dvec, int B, int T_len,
                                      int C, int F, int k, float eps, unsigned threshold,
                                      float inv_keep, int dtype, void* stream) {
  if (F % kFC != 0 || B < 1 || T_len < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{z, dout, wd, w1, w1T, b1, w2f, w2fT, lnp, seed, dz, dwd, dw1, dw2f, db1, dvec,
               T_len, F, k, eps, threshold, inv_keep};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == lfs2::kBF16 ? dispatch<__nv_bfloat16>(C, a, B, s)
                                               : dispatch<float>(C, a, B, s);
  return static_cast<int>(err);
}

// ffn_ln: the deterministic FFN half of a conformer FFT block, fused.
//
//   t1  = LN1(z)                     (rows outside [0, T) zeroed, rounded to T)
//   h0  = depthwise_k(t1) + bd       (f32 taps, rounded to T)
//   up  = relu(h0 @ W1 + b1)         (f32 accumulation, rounded to T)
//   out = LN2(t1 + (up @ W2f + b2f)) (grouped k=1 conv folded into W2f)
//
// Replaces lightningfastspeech2_tpu/ops/pallas_ffn.py _ffn_kernel (called by
// fused_ffn_ln). z is (B, T, C) in f32 or bf16; W1 (C, F) and W2f (F, C) are
// in the same dtype; wd (k, C), b1 (F) and lnp (6, C) = [g1, be1, g2, be2,
// bd, b2f] are f32.
//
// What bounds it on an H100: operations. At the flagship C=256, F=1024 a row
// costs 2*2*C*F = 1.05 MFLOP against 2*C*sizeof(T) bytes of activation
// traffic (the weights, 1 MB in f32, stay in L2), about 1000 FLOP per byte.
// What the design does about it: like the TPU kernel it keeps every
// intermediate on chip. One block owns a 32-row time tile and loads it once
// with its k-1 halo rows; LN1, the depthwise taps, the (32, F) up-projection
// and the down-projection run from shared memory and registers, F in chunks
// of 128, so the (T, F) activation never reaches device memory. The products
// use plain f32 FMAs on the CUDA cores (simple first); tensor cores are the
// next step.
//
// Shapes the kernel takes: C = 32 * CN with CN in {1, 2, 4, 8}, F a multiple
// of 128, any k >= 1 and any T >= 1.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;   // output rows per block
constexpr int kFChunk = 128;  // filter columns per up/down chunk

template <typename T, int CN>
__global__ void __launch_bounds__(kThreads)
ffn_ln_kernel(const T* __restrict__ z, T* __restrict__ out, const float* __restrict__ wd,
              const T* __restrict__ w1, const float* __restrict__ b1, const T* __restrict__ w2f,
              const float* __restrict__ lnp, int T_len, int F, int k, float eps) {
  constexpr int C = 32 * CN;
  extern __shared__ __align__(16) float smem[];
  const int lpad = (k - 1) / 2;
  const int rows_in = kTile + k - 1;
  float* t1 = smem;                    // rows_in x C, LN1 output
  float* h0 = t1 + rows_in * C;        // kTile x C, depthwise output; later the residual
  float* up = h0 + kTile * C;          // kTile x kFChunk

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const T* zb = z + static_cast<size_t>(b) * T_len * C;
  const float* g1 = lnp;
  const float* be1 = lnp + C;
  const float* g2 = lnp + 2 * C;
  const float* be2 = lnp + 3 * C;
  const float* bd = lnp + 4 * C;
  const float* b2f = lnp + 5 * C;

  // 1. LN1 over the tile and its halo, one warp per row
  for (int r = warp; r < rows_in; r += kThreads / 32) {
    const int g = t0 - lpad + r;
    float v[CN];
    if (g < 0 || g >= T_len) {
#pragma unroll
      for (int i = 0; i < CN; ++i) t1[r * C + lane + 32 * i] = 0.0f;
      continue;
    }
    float s = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < CN; ++i) {
      v[i] = lfs2::to_f(zb[static_cast<size_t>(g) * C + lane + 32 * i]);
      s += v[i];
      s2 += v[i] * v[i];
    }
    s = lfs2::warp_sum(s);
    s2 = lfs2::warp_sum(s2);
    const float mean = s / C;
    const float var = fmaxf(s2 / C - mean * mean, 0.0f);
    const float inv = rsqrtf(var + eps);
#pragma unroll
    for (int i = 0; i < CN; ++i) {
      const int c = lane + 32 * i;
      t1[r * C + c] = lfs2::round_to<T>((v[i] - mean) * inv * g1[c] + be1[c]);
    }
  }
  __syncthreads();

  // 2. depthwise conv: h0[i] = sum_j t1[i + j] * wd[j] + bd
  for (int idx = threadIdx.x; idx < kTile * C; idx += kThreads) {
    const int i = idx / C, c = idx % C;
    float acc = 0.0f;
    for (int j = 0; j < k; ++j) acc += t1[(i + j) * C + c] * wd[j * C + c];
    h0[idx] = lfs2::round_to<T>(acc + bd[c]);
  }
  __syncthreads();

  // 3. up/down projections over F in chunks; acc holds rows
  //    warp*4 .. warp*4+3 and columns lane*CN .. lane*CN+CN-1
  const int row0 = warp * 4;
  const int c0 = lane * CN;
  float acc[4][CN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.0f;

  for (int f0 = 0; f0 < F; f0 += kFChunk) {
    // up chunk: rows row0..row0+3, columns f0 + lane*4 .. +3
    float u[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) u[i][j] = 0.0f;
    const T* w1c = w1 + f0 + lane * 4;
#pragma unroll 4
    for (int ci = 0; ci < C; ++ci) {
      float wv[4];
      lfs2::load_vec<4>(w1c + static_cast<size_t>(ci) * F, wv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float hv = h0[(row0 + i) * C + ci];
#pragma unroll
        for (int j = 0; j < 4; ++j) u[i][j] += hv * wv[j];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = u[i][j] + b1[f0 + lane * 4 + j];
        up[(row0 + i) * kFChunk + lane * 4 + j] = lfs2::round_to<T>(fmaxf(x, 0.0f));
      }
    __syncthreads();
    // down chunk: acc += up (4 x 128) @ W2f[f0:f0+128, c0:c0+CN]
    const T* w2c = w2f + static_cast<size_t>(f0) * C + c0;
#pragma unroll 4
    for (int f = 0; f < kFChunk; ++f) {
      float wv[CN];
      lfs2::load_vec<CN>(w2c + static_cast<size_t>(f) * C, wv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float uv = up[(row0 + i) * kFChunk + f];
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] += uv * wv[j];
      }
    }
    __syncthreads();
  }

  // 4. residual on the LN1 output (not on z), into h0
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int r = row0 + i, c = c0 + j;
      h0[r * C + c] = t1[(r + lpad) * C + c] + (acc[i][j] + b2f[c]);
    }
  __syncthreads();

  // 5. LN2, one warp per row
  T* ob = out + static_cast<size_t>(b) * T_len * C;
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const int g = t0 + r;
    if (g >= T_len) break;
    float v[CN];
    float s = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < CN; ++i) {
      v[i] = h0[r * C + lane + 32 * i];
      s += v[i];
      s2 += v[i] * v[i];
    }
    s = lfs2::warp_sum(s);
    s2 = lfs2::warp_sum(s2);
    const float mean = s / C;
    const float var = fmaxf(s2 / C - mean * mean, 0.0f);
    const float inv = rsqrtf(var + eps);
#pragma unroll
    for (int i = 0; i < CN; ++i) {
      const int c = lane + 32 * i;
      ob[static_cast<size_t>(g) * C + c] = lfs2::from_f<T>((v[i] - mean) * inv * g2[c] + be2[c]);
    }
  }
}

template <typename T, int CN>
cudaError_t launch(const void* z, void* out, const float* wd, const void* w1, const float* b1,
                   const void* w2f, const float* lnp, int B, int T_len, int F, int k, float eps,
                   cudaStream_t stream) {
  constexpr int C = 32 * CN;
  const int smem = ((kTile + k - 1) * C + kTile * C + kTile * kFChunk) * static_cast<int>(sizeof(float));
  auto kernel = ffn_ln_kernel<T, CN>;
  cudaError_t err = lfs2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T_len + kTile - 1) / kTile, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(z), static_cast<T*>(out), wd, static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2f), lnp, T_len, F, k, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int C, const void* z, void* out, const float* wd, const void* w1,
                     const float* b1, const void* w2f, const float* lnp, int B, int T_len, int F,
                     int k, float eps, cudaStream_t s) {
  switch (C) {
    case 32: return launch<T, 1>(z, out, wd, w1, b1, w2f, lnp, B, T_len, F, k, eps, s);
    case 64: return launch<T, 2>(z, out, wd, w1, b1, w2f, lnp, B, T_len, F, k, eps, s);
    case 128: return launch<T, 4>(z, out, wd, w1, b1, w2f, lnp, B, T_len, F, k, eps, s);
    case 256: return launch<T, 8>(z, out, wd, w1, b1, w2f, lnp, B, T_len, F, k, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

LFS2_DEFINE_ERROR_STRING

LFS2_EXPORT int lfs2_ffn_ln(const void* z, void* out, const float* wd, const void* w1,
                            const float* b1, const void* w2f, const float* lnp, int B, int T_len,
                            int C, int F, int k, float eps, int dtype, void* stream) {
  if (F % kFChunk != 0 || k < 1 || B < 1 || T_len < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == lfs2::kBF16
          ? dispatch<__nv_bfloat16>(C, z, out, wd, w1, b1, w2f, lnp, B, T_len, F, k, eps, s)
          : dispatch<float>(C, z, out, wd, w1, b1, w2f, lnp, B, T_len, F, k, eps, s);
  return static_cast<int>(err);
}

// lvc_stack: FastDiff's time-aware LVC chain, every layer of one upsample
// stage in one launch.
//
// Per layer i (d = 3^i), on x (B, L, C = 32) with audio_down ad:
//   x = round(x + ad); y1 = round(leaky(x, 0.2))          zero outside [0, L)
//   y2 = round(leaky(conv3_d(y1) + conv_b[i], 0.2))       f32 sum, zero outside
//   g[t] = sum_k y2[t - 1 + k] @ K_f[i][:, :, k] + bias_f[i]   (f = t / hop)
//   x = round(x + round(sigmoid(g[:C]) * tanh(g[C:])))    (or the Padé gate)
// round() is the working dtype (f32 or bf16); products sum in f32; biases
// and conv biases are f32. The per-frame kernels K are read in the kernel
// predictor's layout, (B, nL, layers, C_in, 2C, 3), straight from device
// memory; conv_w is (layers, 3, C_in, C_out).
//
// Replaces lightningfastspeech2_tpu/ops/pallas_fastdiff.py _stack_kernel
// (fused_lvc_stack). The TPU kernel's prev/cur/next halo blocks, its halo of
// whole frames, the VMEM-sized frame tiles and the transposed, padded copy of
// the LVC kernels were Mosaic workarounds and are not carried over: a block
// here owns `tile` output rows and a halo in rows, and every row finds its
// frame's kernel by t / hop, so no shape is refused.
//
// What bounds it on an H100: bytes. At a 512-frame bucket in bf16, stage 3
// (hop 256, L = 131,072) reads x, ad and 25 MB of per-frame kernels and
// writes x: about 51 MB (15 us at 3.35 TB/s) against 9.7 GFLOP (9.8 us at
// the bf16 tensor-core peak); stage 2 (hop 64) about 31 MB, most of it the
// per-frame kernels, whose size does not depend on the hop. What the design
// does about it: x, ad and both intermediate signals of the whole chain stay
// in shared memory for all layers, so each input byte is read once and the
// output written once; only the halo rows (48 a side) are read again by the
// neighbouring block, and the per-frame kernels come once per frame from
// device memory (L1/L2 for the rows after the first). The products are plain
// f32 FMAs on the CUDA cores, lane = channel (C = 32 is one warp); tensor
// cores for the per-frame (hop, 96) @ (96, 64) products are later work.
#include "common.cuh"

namespace {

constexpr int C = 32;  // channels: one warp's lanes
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 6;
constexpr int kAlign = 4;     // region rounding; rows per chunk when hop % 4 == 0
constexpr int kConvRows = 4;  // rows per chunk of the dilated conv
constexpr int kMaxSmem = 232448;

// Buffer rows (row 0 is signal position blockIdx.x * tile - halo) of each
// step of each layer: the residual add and leaky [a_lo, a_hi), the dilated
// conv [b_lo, b_hi), the LVC and gate [c_lo, c_hi). Each step covers what
// the next one reads; c of the last layer covers the tile.
struct Spec {
  int layers, halo, rows;
  int a_lo[kMaxLayers], a_hi[kMaxLayers];
  int b_lo[kMaxLayers], b_hi[kMaxLayers];
  int c_lo[kMaxLayers], c_hi[kMaxLayers];
};

__device__ __forceinline__ float fast_tanh(float t) {
  // clamped Padé(7,6), as vocoder/fastdiff.py fast_tanh
  t = fminf(fmaxf(t, -4.97f), 4.97f);
  const float t2 = t * t;
  const float num = t * (135135.0f + t2 * (17325.0f + t2 * (378.0f + t2)));
  const float den = 135135.0f + t2 * (62370.0f + t2 * (3150.0f + t2 * 28.0f));
  return fminf(fmaxf(num / den, -1.0f), 1.0f);
}

template <bool FAST>
__device__ __forceinline__ float gate(float a, float b) {
  if (FAST) return (0.5f * (fast_tanh(0.5f * a) + 1.0f)) * fast_tanh(b);
  return (1.0f / (1.0f + expf(-a))) * tanhf(b);
}

template <typename T, int RPT, bool FAST>
__global__ void __launch_bounds__(kThreads)
lvc_stack_kernel(const T* __restrict__ x, const T* __restrict__ ad, const T* __restrict__ kern,
                 const float* __restrict__ bias, const T* __restrict__ conv_w,
                 const float* __restrict__ conv_b, T* __restrict__ out, int L, int hop,
                 int tile, Spec spec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int R = spec.rows;
  T* xs = reinterpret_cast<T*>(smem_raw);  // x, rounded to T
  T* as = xs + R * C;                      // audio_down
  T* y1 = as + R * C;                      // leaky(x): the conv's input
  T* y2 = y1 + R * C;                      // the LVC's input (last: see the conv below)
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int g0 = t0 - spec.halo;
  const int nL = L / hop;
  const long long base = static_cast<long long>(b) * L * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T zero = lfs2::from_f<T>(0.0f);

  for (int idx = spec.a_lo[0] * C + threadIdx.x; idx < spec.a_hi[0] * C; idx += kThreads) {
    const int g = g0 + idx / C;
    const bool in = g >= 0 && g < L;
    const long long o = base + static_cast<long long>(g) * C + (idx % C);
    xs[idx] = in ? x[o] : zero;
    as[idx] = in ? ad[o] : zero;
  }
  __syncthreads();

  int d = 1;
  for (int i = 0; i < spec.layers; ++i, d *= 3) {
    // residual add, then the conv's input
    for (int idx = spec.a_lo[i] * C + threadIdx.x; idx < spec.a_hi[i] * C; idx += kThreads) {
      const int g = g0 + idx / C;
      const float v = lfs2::round_to<T>(lfs2::to_f(xs[idx]) + lfs2::to_f(as[idx]));
      xs[idx] = lfs2::from_f<T>(v);
      const float y = fmaxf(v, lfs2::round_to<T>(v * 0.2f));
      y1[idx] = (g >= 0 && g < L) ? lfs2::from_f<T>(y) : zero;
    }
    __syncthreads();

    // dilated conv, lane = output channel, kConvRows rows a chunk. A chunk's
    // last rows may lie past b_hi and read up to kConvRows - 1 rows past
    // the end of y1's region: they lie inside y2's buffer and the results
    // are dropped.
    {
      const T* w = conv_w + static_cast<long long>(i) * 3 * C * C + lane;
      const float cb = conv_b[i * C + lane];
      for (int r0 = spec.b_lo[i] + warp * kConvRows; r0 < spec.b_hi[i];
           r0 += kWarps * kConvRows) {
        float acc[kConvRows];
#pragma unroll
        for (int rr = 0; rr < kConvRows; ++rr) acc[rr] = cb;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const T* src = y1 + (r0 + (j - 1) * d) * C;
          const T* wj = w + j * C * C;
#pragma unroll
          for (int ci0 = 0; ci0 < C; ci0 += 8) {
            float wv[8];
#pragma unroll
            for (int q = 0; q < 8; ++q) wv[q] = lfs2::to_f(wj[(ci0 + q) * C]);
#pragma unroll
            for (int rr = 0; rr < kConvRows; ++rr) {
              float yv[8];
              lfs2::load_vec<8>(src + rr * C + ci0, yv);
#pragma unroll
              for (int q = 0; q < 8; ++q) acc[rr] = fmaf(yv[q], wv[q], acc[rr]);
            }
          }
        }
#pragma unroll
        for (int rr = 0; rr < kConvRows; ++rr) {
          const int r = r0 + rr;
          if (r >= spec.b_hi[i]) break;
          const int g = g0 + r;
          const float v = fmaxf(acc[rr], acc[rr] * 0.2f);
          y2[r * C + lane] = (g >= 0 && g < L) ? lfs2::from_f<T>(v) : zero;
        }
      }
    }
    __syncthreads();

    // LVC with the frame's own kernel and bias, then the gate. A chunk's RPT
    // rows start at a multiple of RPT and hop % RPT == 0, so they share one
    // frame and lie all inside [0, L) or all outside it.
    for (int r0 = spec.c_lo[i] + warp * RPT; r0 < spec.c_hi[i]; r0 += kWarps * RPT) {
      const int g = g0 + r0;
      if (g < 0 || g >= L) continue;
      const long long fi = (static_cast<long long>(b) * nL + g / hop) * spec.layers + i;
      const T* K = kern + fi * (C * 2 * C * 3) + lane * 3;
      const float* bs = bias + fi * (2 * C);
      float acc_a[RPT], acc_b[RPT];
#pragma unroll
      for (int rr = 0; rr < RPT; ++rr) {
        acc_a[rr] = bs[lane];
        acc_b[rr] = bs[lane + C];
      }
#pragma unroll 1
      for (int ci0 = 0; ci0 < C; ci0 += 8) {
        float yv[RPT + 2][8];
#pragma unroll
        for (int q = 0; q < RPT + 2; ++q) lfs2::load_vec<8>(y2 + (r0 - 1 + q) * C + ci0, yv[q]);
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) {
          const T* ka = K + (ci0 + cc) * (2 * C * 3);
          const T* kb = ka + C * 3;
          const float wa0 = lfs2::to_f(ka[0]), wa1 = lfs2::to_f(ka[1]), wa2 = lfs2::to_f(ka[2]);
          const float wb0 = lfs2::to_f(kb[0]), wb1 = lfs2::to_f(kb[1]), wb2 = lfs2::to_f(kb[2]);
#pragma unroll
          for (int rr = 0; rr < RPT; ++rr) {
            acc_a[rr] = fmaf(yv[rr][cc], wa0, acc_a[rr]);
            acc_a[rr] = fmaf(yv[rr + 1][cc], wa1, acc_a[rr]);
            acc_a[rr] = fmaf(yv[rr + 2][cc], wa2, acc_a[rr]);
            acc_b[rr] = fmaf(yv[rr][cc], wb0, acc_b[rr]);
            acc_b[rr] = fmaf(yv[rr + 1][cc], wb1, acc_b[rr]);
            acc_b[rr] = fmaf(yv[rr + 2][cc], wb2, acc_b[rr]);
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < RPT; ++rr) {
        T* xp = xs + (r0 + rr) * C + lane;
        const float gv = lfs2::round_to<T>(gate<FAST>(acc_a[rr], acc_b[rr]));
        *xp = lfs2::from_f<T>(lfs2::to_f(*xp) + gv);
      }
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < tile * C; idx += kThreads) {
    const int g = t0 + idx / C;
    if (g >= L) break;
    out[base + static_cast<long long>(g) * C + (idx % C)] = xs[spec.halo * C + idx];
  }
}

int floor_to(int v, int m) { return v >= 0 ? v / m * m : -((-v + m - 1) / m) * m; }

Spec make_spec(int layers, int tile) {
  Spec s = {};
  s.layers = layers;
  int lo = 0, hi = tile;  // rows relative to the tile's first
  int d = 1;
  for (int i = 1; i < layers; ++i) d *= 3;
  for (int i = layers - 1; i >= 0; --i, d /= 3) {
    s.c_lo[i] = floor_to(lo, kAlign);
    s.c_hi[i] = -floor_to(-hi, kAlign);
    s.b_lo[i] = s.c_lo[i] - 1;
    s.b_hi[i] = s.c_hi[i] + 1;
    s.a_lo[i] = s.b_lo[i] - d;
    s.a_hi[i] = s.b_hi[i] + d;
    lo = s.a_lo[i];
    hi = s.a_hi[i];
  }
  const int ext = -lo > hi - tile ? -lo : hi - tile;
  s.halo = -floor_to(-ext, kAlign);
  s.rows = tile + 2 * s.halo;
  for (int i = 0; i < layers; ++i) {
    s.a_lo[i] += s.halo; s.a_hi[i] += s.halo;
    s.b_lo[i] += s.halo; s.b_hi[i] += s.halo;
    s.c_lo[i] += s.halo; s.c_hi[i] += s.halo;
  }
  return s;
}

template <typename T, int RPT, bool FAST>
cudaError_t launch(const void* x, const void* ad, const void* kern, const float* bias,
                   const void* conv_w, const float* conv_b, void* out, int B, int L, int hop,
                   int tile, const Spec& spec, cudaStream_t stream) {
  const int smem = 4 * spec.rows * C * static_cast<int>(sizeof(T));
  auto kernel = lvc_stack_kernel<T, RPT, FAST>;
  cudaError_t err = lfs2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + tile - 1) / tile, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ad), static_cast<const T*>(kern), bias,
      static_cast<const T*>(conv_w), conv_b, static_cast<T*>(out), L, hop, tile, spec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* ad, const void* kern, const float* bias,
                     const void* conv_w, const float* conv_b, void* out, int B, int L, int hop,
                     int tile, int fast, const Spec& spec, cudaStream_t s) {
  const bool quad = hop % kAlign == 0;
  if (fast) {
    return quad ? launch<T, kAlign, true>(x, ad, kern, bias, conv_w, conv_b, out, B, L, hop, tile, spec, s)
                : launch<T, 1, true>(x, ad, kern, bias, conv_w, conv_b, out, B, L, hop, tile, spec, s);
  }
  return quad ? launch<T, kAlign, false>(x, ad, kern, bias, conv_w, conv_b, out, B, L, hop, tile, spec, s)
              : launch<T, 1, false>(x, ad, kern, bias, conv_w, conv_b, out, B, L, hop, tile, spec, s);
}

}  // namespace

LFS2_DEFINE_ERROR_STRING

// x, ad, out (B, L, 32); kern (B, L / hop, layers, 32, 64, 3) and conv_w
// (layers, 3, 32, 32) in the working dtype; bias (B, L / hop, layers, 64) and
// conv_b (layers, 32) f32. tile: output rows per block, a multiple of 4.
LFS2_EXPORT int lfs2_lvc_stack(const void* x, const void* ad, const void* kern, const float* bias,
                               const void* conv_w, const float* conv_b, void* out, int B, int L,
                               int hop, int layers, int tile, int fast, int dtype, void* stream) {
  if (B < 1 || L < 1 || hop < 1 || L % hop != 0 || layers < 1 || layers > kMaxLayers ||
      tile < kAlign || tile % kAlign != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Spec spec = make_spec(layers, tile);
  const int elem = dtype == lfs2::kBF16 ? 2 : 4;
  if (4 * spec.rows * C * elem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == lfs2::kBF16
          ? dispatch<__nv_bfloat16>(x, ad, kern, bias, conv_w, conv_b, out, B, L, hop, tile, fast, spec, s)
          : dispatch<float>(x, ad, kern, bias, conv_w, conv_b, out, B, L, hop, tile, fast, spec, s);
  return static_cast<int>(err);
}

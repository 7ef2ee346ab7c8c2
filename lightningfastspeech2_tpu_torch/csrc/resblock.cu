// resblock / resblock_trio: HiFi-GAN ResBlock1 fused, one or three at once.
//
// One ResBlock1 (reference hifigan models.py:20-93) is, for p = 0, 1, 2:
//   t = leaky(x) -> conv_k,d_p -> +b -> leaky (f32) -> cast -> conv_k,1 -> +b
//   x = x + cast(t)
// with leaky(v) = max(v, 0.1 v), every conv zero-padded at the signal edges
// (outputs zeroed outside [0, L)), f32 accumulation, bias and leaky in f32.
// The trio runs the three ResBlock1s of one upsample stage (k = 3, 7, 11)
// from one read of the input and averages them: out = ((x1 + x2) + x3) / 3
// with each step rounded to the working dtype.
//
// Replaces lightningfastspeech2_tpu/ops/pallas_hifigan.py _resblock_kernel
// (fused_resblock) and _resblock_trio_kernel (fused_resblock_trio). The TPU
// kernels folded time into lanes (tap_blocks) to fill the MXU; that trick is
// not carried over: this kernel takes the unfolded (B, L, C) signal and
// (k, C_in, C_out) tap weights, and the dtype is f32 or bf16.
//
// What bounds it on an H100: operations. Six convs of k taps cost
// 2*k*C*C FLOP per sample each; at C=256, k=11 that is ~8.7 MFLOP per
// sample against 4*C bytes of input and output. What the design does about
// it: one block owns a time tile plus a halo equal to the sum of the six
// convs' reaches (60 samples for k=11, d=1,3,5), so all six (or eighteen)
// convs, leaky_relus and residual adds run from on-chip memory and only the
// tile's output is written back. Each conv computes exactly the rows the
// next one needs (the valid region shrinks by the conv's reach), and the
// halo rows are recomputed by the neighbouring block: PERF.md records that
// share. Conv outputs live in shared memory; the residual signal does too
// when two buffers fit, otherwise (f32 at C=256) in a per-block scratch
// slice of device memory that stays in L2. Tap weights (1.4 MB for one
// k=11 conv at C=256 in bf16) cannot fit in shared memory and stream from
// L2. The products are plain f32 FMAs on the CUDA cores (simple first).
//
// Shapes the kernel takes: C = 32 * CN with CN in {1, 2, 4, 8}, up to three
// resblocks of up to three dilation pairs each, any L >= 1.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kRowsPerPass = kRowsPerThread * (kThreads / 32);
constexpr int kMaxRes = 3;
constexpr int kMaxPairs = 3;

struct Spec {
  int n_res;
  int k[kMaxRes];
  int n_pairs[kMaxRes];
  int dil[kMaxRes][kMaxPairs];
  int reach[kMaxRes];                    // sum of the resblock's conv reaches
  long long w_off[kMaxRes][2 * kMaxPairs];  // element offsets of each conv's taps
  int b_off[kMaxRes][2 * kMaxPairs];        // row of each conv's bias
};

// One dilated conv over buffer rows [olo, ohi):
//   y[r] = sum_j sum_ci in[r + j*d - p][ci] * W[j][ci][:] + bias, zero
// where the row's signal position lies outside [0, L). LEAKY_IN applies
// leaky (rounded to T) to the input as it is read; FIRST stores
// leaky(y) rounded to T into dst, otherwise dst += round(y) (rounded to T).
template <typename T, int CN, bool FIRST>
__device__ void conv_rows(const T* src, T* dst, const T* __restrict__ w,
                          const float* __restrict__ bias, int olo, int ohi, int k, int d,
                          int g0, int L) {
  constexpr int C = 32 * CN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = lane * CN;
  const int p = d * (k - 1) / 2;
  float bv[CN];
  lfs2::load_vec<CN>(bias + c0, bv);
  for (int rb = olo + warp * kRowsPerThread; rb < ohi; rb += kRowsPerPass) {
    float acc[kRowsPerThread][CN];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = 0.0f;
    for (int j = 0; j < k; ++j) {
      const T* in = src + static_cast<long long>(rb + j * d - p) * C;
      const T* wj = w + static_cast<long long>(j) * C * C + c0;
#pragma unroll 4
      for (int ci = 0; ci < C; ++ci) {
        float wv[CN];
        lfs2::load_vec<CN>(wj + ci * C, wv);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          float a = lfs2::to_f(in[i * C + ci]);
          if (FIRST) a = fmaxf(a, lfs2::round_to<T>(a * 0.1f));
#pragma unroll
          for (int jj = 0; jj < CN; ++jj) acc[i][jj] += a * wv[jj];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = rb + i;
      if (r >= ohi) break;
      const int g = g0 + r;
      const bool inside = g >= 0 && g < L;
      T* o = dst + static_cast<long long>(r) * C + c0;
#pragma unroll
      for (int jj = 0; jj < CN; ++jj) {
        float v = inside ? acc[i][jj] + bv[jj] : 0.0f;
        if (FIRST) {
          o[jj] = lfs2::from_f<T>(fmaxf(v, v * 0.1f));
        } else {
          o[jj] = lfs2::from_f<T>(lfs2::to_f(o[jj]) + lfs2::round_to<T>(v));
        }
      }
    }
  }
}

template <typename T, int CN>
__global__ void __launch_bounds__(kThreads)
resblock_kernel(const T* __restrict__ x, T* __restrict__ out, const T* __restrict__ w,
                const float* __restrict__ bias, T* __restrict__ scratch, int L, int tile,
                int halo, Spec spec, int x_in_smem) {
  constexpr int C = 32 * CN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // buffers hold R rows plus kRowsPerThread rows of slack for the last pass
  const int rows = tile + 2 * halo + kRowsPerThread;
  T* tbuf = reinterpret_cast<T*>(smem_raw);
  T* xbuf = x_in_smem
                ? tbuf + static_cast<long long>(rows) * C
                : scratch + (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * rows * C;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int g0 = t0 - halo;  // signal position of buffer row 0
  const T* xb = x + static_cast<long long>(b) * L * C;
  T* ob = out + static_cast<long long>(b) * L * C;

  for (int r = 0; r < spec.n_res; ++r) {
    int lo = halo - spec.reach[r];
    int hi = halo + tile + spec.reach[r];
    for (int idx = threadIdx.x; idx < (hi - lo) * C; idx += kThreads) {
      const int row = lo + idx / C, c = idx % C;
      const int g = g0 + row;
      xbuf[static_cast<long long>(row) * C + c] =
          (g >= 0 && g < L) ? xb[static_cast<long long>(g) * C + c] : lfs2::from_f<T>(0.0f);
    }
    __syncthreads();
    const int k = spec.k[r];
    for (int pr = 0; pr < spec.n_pairs[r]; ++pr) {
      const int d = spec.dil[r][pr];
      const int q1 = d * (k - 1) / 2;
      conv_rows<T, CN, true>(xbuf, tbuf, w + spec.w_off[r][2 * pr], bias + spec.b_off[r][2 * pr] * C,
                             lo + q1, hi - q1, k, d, g0, L);
      lo += q1;
      hi -= q1;
      __syncthreads();
      const int q2 = (k - 1) / 2;
      conv_rows<T, CN, false>(tbuf, xbuf, w + spec.w_off[r][2 * pr + 1],
                              bias + spec.b_off[r][2 * pr + 1] * C, lo + q2, hi - q2, k, 1, g0, L);
      lo += q2;
      hi -= q2;
      __syncthreads();
    }
    // combine the tile's rows into the output: x1, then ((x1 + x2) + x3) / 3
    for (int idx = threadIdx.x; idx < tile * C; idx += kThreads) {
      const int i = idx / C, c = idx % C;
      const int g = t0 + i;
      if (g >= L) break;
      const long long o = static_cast<long long>(g) * C + c;
      const float v = lfs2::to_f(xbuf[static_cast<long long>(halo + i) * C + c]);
      if (r == 0) {
        ob[o] = lfs2::from_f<T>(v);
      } else {
        float s = lfs2::round_to<T>(lfs2::to_f(ob[o]) + v);
        if (r == spec.n_res - 1) s = s / static_cast<float>(spec.n_res);
        ob[o] = lfs2::from_f<T>(s);
      }
    }
    __syncthreads();
  }
}

template <typename T, int CN>
cudaError_t launch(const void* x, void* out, const void* w, const float* bias, void* scratch,
                   int B, int L, int tile, int halo, const Spec& spec, int x_in_smem,
                   cudaStream_t stream) {
  constexpr int C = 32 * CN;
  const int rows = tile + 2 * halo + kRowsPerThread;
  const int smem = rows * C * static_cast<int>(sizeof(T)) * (x_in_smem ? 2 : 1);
  auto kernel = resblock_kernel<T, CN>;
  cudaError_t err = lfs2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + tile - 1) / tile, B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<T*>(out),
                                           static_cast<const T*>(w), bias,
                                           static_cast<T*>(scratch), L, tile, halo, spec,
                                           x_in_smem);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int C, const void* x, void* out, const void* w, const float* bias,
                     void* scratch, int B, int L, int tile, int halo, const Spec& spec,
                     int x_in_smem, cudaStream_t s) {
  switch (C) {
    case 32: return launch<T, 1>(x, out, w, bias, scratch, B, L, tile, halo, spec, x_in_smem, s);
    case 64: return launch<T, 2>(x, out, w, bias, scratch, B, L, tile, halo, spec, x_in_smem, s);
    case 128: return launch<T, 4>(x, out, w, bias, scratch, B, L, tile, halo, spec, x_in_smem, s);
    case 256: return launch<T, 8>(x, out, w, bias, scratch, B, L, tile, halo, spec, x_in_smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

LFS2_DEFINE_ERROR_STRING

// layout: n_res groups of [k, n_pairs, d_0, .., d_{n_pairs-1}]; the taps of
// resblock r, pair p are w[conv], conv = r*2*n_pairs + 2p (+1 for the
// second conv), each (k, C, C); bias is (n_convs, C) f32.
LFS2_EXPORT int lfs2_resblock(const void* x, void* out, const void* w, const float* bias,
                              void* scratch, int B, int L, int C, int tile, int halo,
                              const int* layout, int n_res, int x_in_smem, int dtype,
                              void* stream) {
  if (n_res < 1 || n_res > kMaxRes || B < 1 || L < 1 || tile < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Spec spec = {};
  spec.n_res = n_res;
  long long w_off = 0;
  int b_off = 0;
  int pos = 0;
  for (int r = 0; r < n_res; ++r) {
    const int k = layout[pos++];
    const int np = layout[pos++];
    if (k < 1 || np < 1 || np > kMaxPairs) return static_cast<int>(cudaErrorInvalidValue);
    spec.k[r] = k;
    spec.n_pairs[r] = np;
    int reach = 0;
    for (int p = 0; p < np; ++p) {
      const int d = layout[pos++];
      spec.dil[r][p] = d;
      reach += d * (k - 1) / 2 + (k - 1) / 2;
      for (int e = 0; e < 2; ++e) {
        spec.w_off[r][2 * p + e] = w_off;
        spec.b_off[r][2 * p + e] = b_off;
        w_off += static_cast<long long>(k) * C * C;
        b_off += 1;
      }
    }
    if (reach > halo) return static_cast<int>(cudaErrorInvalidValue);
    spec.reach[r] = reach;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == lfs2::kBF16
          ? dispatch<__nv_bfloat16>(C, x, out, w, bias, scratch, B, L, tile, halo, spec, x_in_smem, s)
          : dispatch<float>(C, x, out, w, bias, scratch, B, L, tile, halo, spec, x_in_smem, s);
  return static_cast<int>(err);
}

// ffn_ln: the FFN half of a conformer FFT block, fused, for serving and
// for training.
//
//   t1  = LN1(z)                     (rows outside [0, T) zeroed, rounded to T)
//   h0  = depthwise_k(t1) + bd       (f32 taps, rounded to T)
//   up  = relu(h0 @ W1 + b1)         (f32 accumulation, rounded to T)
//   out = LN2(t1 + (up @ W2f + b2f)) (grouped k=1 conv folded into W2f)
//
// Replaces lightningfastspeech2_tpu/ops/pallas_ffn.py _ffn_kernel (called by
// fused_ffn_ln) and _ffn_train_kernel (fused_ffn_ln_train's forward), which
// adds two dropouts: keep1 drops the rounded ReLU output, keep2 the FFN
// output before the residual, each kept value scaled by 1 / (1 - rate) and
// the up value rounded again. Both masks hash the global row, the column
// and a per-item seed (lfs2::ffn_keep, bit for bit pallas_ffn.py _pos_keep),
// so the backward's other tiling reproduces them. z is (B, T, C); wd (k, C),
// b1 (F) and lnp (6, C) = [g1, be1, g2, be2, bd, b2f] are f32.
//
// What bounds it on an H100: operations. At the flagship C=256, F=1024 a
// row costs 2*2*C*F = 1.05 MFLOP against 2*C*sizeof(T) bytes of activation
// traffic, about 1000 FLOP per byte. Like the TPU kernel, every route keeps
// the (T, F) intermediate on chip.
//
// bf16 route (ffn_ln_kernel): the products on the tensor cores. A block
// owns 128 rows of one item: all 256 threads form LN1 over the rows and
// their k - 1 halo (t1 window, shared memory) and the depthwise taps on the
// CUDA cores (16 rows by 2 channels a thread, taps 8 at a time from a
// register window; the taps in shared memory) into h0, a swizzled tile.
// Then the weights stream F-chunk by F-chunk (64 columns: a W1 and a W2f
// matrix, pre-swizzled by ops/ffn.py _weight_image, one bulk copy each)
// through two buffers, each refilled by the last warp to release it, and
// the block's two warpgroups (64 rows each) run per chunk:
//   up (64 x 64) = h0 @ W1 chunk       wgmma, both operands in shared memory
//   + b1, relu, round, keep1 and scale, round, in registers
//   ff (64 x C) += up @ W2f chunk      wgmma, up staged in shared memory
//                                      (16 KB, where the t1 window was)
// so each weight chunk is staged once per 128 rows (the CUDA-core code it
// replaces read it from L2 for every 4 rows), and one warpgroup's epilogue
// (the keep hash: row factor hoisted, one per element) overlaps the other's
// products. A thread holds the 64 x C f32 ff accumulator and one chunk's
// 64 x 64 at a time (the up chunk goes through shared memory, not
// registers: at C = 256 the register file has no room for more). The LN2
// epilogue hands ff to an f32 row buffer in the shared memory the loop no
// longer needs and runs row by row, C / 8 lanes a row with 16-byte loads
// and stores; the residual's t1 is formed again from z with the row
// statistics LN1 kept. Three epilogues: serve (LN2, store), train (keep2,
// LN2, store) and the backward's chain (ffn_ln_train_bwd.cu's stage (a):
// keep2, the LN2 backward from dout; writes h0, dres (f32), dff = keep2
// dres / (1 - r) (bf16), and dg2, dbe2, db2f partials). C = 32 runs as
// C = 64 with zero channels.
//
// f32 route (ffn_ln_f32_kernel): the tensor cores have no f32 product; one
// block owns a 32-row tile, the products are f32 FMAs on the CUDA cores,
// F in chunks of 128.
//
// Shapes the kernel takes: C in {32, 64, 128, 256}, F a multiple of 128,
// any T >= 1; k >= 1 while the t1 window fits shared memory (k <= 63 at
// C = 256 in bf16).
#include "common.cuh"
#include "ffn_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;   // output rows per block
constexpr int kFChunk = 128;  // filter columns per up/down chunk

// dropout of the training forward: the device seed, the keep threshold and
// 1 / (1 - rate)
struct Drop {
  const int* seed;
  unsigned threshold;
  float inv_keep;
};

template <typename T, int CN, bool kTrain>
__global__ void __launch_bounds__(kThreads)
ffn_ln_f32_kernel(const T* __restrict__ z, T* __restrict__ out, const float* __restrict__ wd,
              const T* __restrict__ w1, const float* __restrict__ b1, const T* __restrict__ w2f,
              const float* __restrict__ lnp, int T_len, int F, int k, float eps, Drop drop) {
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
  unsigned seed_b = 0;
  if constexpr (kTrain) seed_b = lfs2::item_seed(*drop.seed, b);

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
        float v = lfs2::round_to<T>(fmaxf(x, 0.0f));
        if constexpr (kTrain) {
          const bool keep = lfs2::ffn_keep(t0 + row0 + i, f0 + lane * 4 + j, seed_b, 1u,
                                           drop.threshold);
          v = lfs2::round_to<T>(keep ? v * drop.inv_keep : 0.0f);
        }
        up[(row0 + i) * kFChunk + lane * 4 + j] = v;
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
      float ff = acc[i][j] + b2f[c];
      if constexpr (kTrain)
        ff = lfs2::ffn_keep(t0 + r, c, seed_b, 2u, drop.threshold) ? ff * drop.inv_keep : 0.0f;
      h0[r * C + c] = t1[(r + lpad) * C + c] + ff;
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

// the latest accepted launch, either route: grid x, y, z, shared-memory
// bytes a block and the rows of one item a block owns
int g_last_launch[5];

cudaError_t record_launch(const dim3& grid, int smem, int rows) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    g_last_launch[0] = grid.x;
    g_last_launch[1] = grid.y;
    g_last_launch[2] = grid.z;
    g_last_launch[3] = smem;
    g_last_launch[4] = rows;
  }
  return err;
}

template <typename T, int CN, bool kTrain>
cudaError_t launch(const void* z, void* out, const float* wd, const void* w1, const float* b1,
                   const void* w2f, const float* lnp, int B, int T_len, int F, int k, float eps,
                   Drop drop, cudaStream_t stream) {
  constexpr int C = 32 * CN;
  const int smem = ((kTile + k - 1) * C + kTile * C + kTile * kFChunk) * static_cast<int>(sizeof(float));
  auto kernel = ffn_ln_f32_kernel<T, CN, kTrain>;
  cudaError_t err = lfs2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T_len + kTile - 1) / kTile, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(z), static_cast<T*>(out), wd, static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2f), lnp, T_len, F, k, eps, drop);
  return record_launch(grid, smem, kTile);
}

template <bool kTrain>
cudaError_t f32_dispatch(int C, const void* z, void* out, const float* wd, const void* w1,
                         const float* b1, const void* w2f, const float* lnp, int B, int T_len,
                         int F, int k, float eps, Drop d, cudaStream_t s) {
  switch (C) {
    case 32: return launch<float, 1, kTrain>(z, out, wd, w1, b1, w2f, lnp, B, T_len, F, k, eps, d, s);
    case 64: return launch<float, 2, kTrain>(z, out, wd, w1, b1, w2f, lnp, B, T_len, F, k, eps, d, s);
    case 128: return launch<float, 4, kTrain>(z, out, wd, w1, b1, w2f, lnp, B, T_len, F, k, eps, d, s);
    case 256: return launch<float, 8, kTrain>(z, out, wd, w1, b1, w2f, lnp, B, T_len, F, k, eps, d, s);
    default: return cudaErrorInvalidValue;
  }
}

// ============================ bf16 route: tensor cores ======================
using ffn::bf16;

struct FwdArgs {
  const bf16* z;
  bf16* out;           // serve / train: the output
  const bf16* dout;    // chain: the output's gradient
  const float* wd;
  const uint8_t* img;  // the weight image, F / 64 chunks of two swizzled matrices
  const float* b1;
  const float* lnp;
  const int* seed;     // null: no dropout
  bf16* h0_out;        // chain: h0, dres, dff (B, T, C) and the (6, C) partials
  float* dres_out;
  bf16* dff_out;
  float* dvec;
  int T, C, F, k;
  float eps;
  unsigned threshold;
  float inv_keep;
};

// value e of an accumulator block: row 0 (e < 2) or 8, column + (e & 1)
__device__ __forceinline__ float pick(float2 v, int e) { return (e & 1) ? v.y : v.x; }

// rows [r0, r1) of the h0 tile into dst (the tile's row 0; C columns), 16
// bytes a step
__device__ __forceinline__ void store_tile(const uint8_t* tile, bf16* dst, int r0, int r1, int C,
                                           int tid, int nthreads) {
  const int pieces = C / 8;
  for (int idx = tid; idx < (r1 - r0) * pieces; idx += nthreads) {
    const int r = r0 + idx / pieces, c = 8 * (idx % pieces);
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * C + c) =
        *reinterpret_cast<const uint4*>(tile + ffn::swz(r, c, ffn::kRows));
  }
}

// LN1 over the W window rows (item rows t_first ..) into t1 (bf16, CP
// columns a row; zero outside [0, T) and beyond C), and each row's mean and
// 1 / sigma. A row takes C / 8 lanes of 8 channels each, so a warp forms
// 32 / (C / 8) rows at once from 16-byte loads, the next rows' loads in
// flight meanwhile.
__device__ __forceinline__ void ln1_window(const bf16* __restrict__ zb, bf16* t1p, float2* stats,
                                           const float* __restrict__ g1,
                                           const float* __restrict__ be1, int t_first, int W,
                                           int T, int C, int CP, float eps) {
  const int G = C / 8, rpw = 32 / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, l = lane % G;
  const int step = (ffn::kThreads / 32) * rpw;
  float gv[8], bv[8];
  lfs2::load_vec<8>(g1 + 8 * l, gv);
  lfs2::load_vec<8>(be1 + 8 * l, bv);
  auto load = [&](int r) {
    const int g = t_first + r;
    return r < W && g >= 0 && g < T
               ? *reinterpret_cast<const uint4*>(zb + static_cast<size_t>(g) * C + 8 * l)
               : make_uint4(0u, 0u, 0u, 0u);
  };
  uint4 next = load(warp * rpw + lane / G);
  for (int r0 = warp * rpw; r0 < W; r0 += step) {
    const int r = r0 + lane / G, g = t_first + r;
    const uint4 raw = next;
    next = load(r + step);
    float v[8], s = 0.0f, s2 = 0.0f;
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s += v[e];
      s2 += v[e] * v[e];
    }
    for (int m = G / 2; m > 0; m >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, m);
      s2 += __shfl_xor_sync(0xffffffffu, s2, m);
    }
    if (r >= W) continue;
    const bool in = g >= 0 && g < T;
    const float mean = s / C;
    const float inv = rsqrtf(fmaxf(s2 / C - mean * mean, 0.0f) + eps);
    uint4 o;
    uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      op[e] = in ? ffn::pack_bf16(ffn::ln_apply(v[2 * e], mean, inv, gv[2 * e], bv[2 * e]),
                                  ffn::ln_apply(v[2 * e + 1], mean, inv, gv[2 * e + 1], bv[2 * e + 1]))
                 : 0u;
    *reinterpret_cast<uint4*>(t1p + r * CP + 8 * l) = o;
    if (C < CP) *reinterpret_cast<uint4*>(t1p + r * CP + C + 8 * l) = make_uint4(0u, 0u, 0u, 0u);
    if (l == 0) stats[r] = make_float2(mean, inv);
  }
}

// ffn_ln_kernel<CP, kChain>: kChain false serves and trains (dropout when a
// seed is given and the rate is not 0); true is the backward's chain
template <int CP, bool kChain>
__global__ void __launch_bounds__(ffn::kThreads, 1)
ffn_ln_kernel(const __grid_constant__ FwdArgs a) {
  using namespace ffn;
  constexpr int kNR = 16;  // depthwise rows a work item
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const int k = a.k, C = a.C, T = a.T;
  const int lpad = (k - 1) / 2, W = kRows + k - 1;
  const uint32_t base = smem_u32(smem);
  const uint32_t w1s = base, w2s = base + wbuf_bytes(CP), h0s = w2s + wbuf_bytes(CP);
  const uint32_t wins = h0s + tile_bytes(CP);
  uint8_t* h0p = smem + (h0s - base);
  uint8_t* win = smem + (wins - base);  // the t1 window, then the up staging
  bf16* t1p = reinterpret_cast<bf16*>(win);
  const float* wdp = reinterpret_cast<const float*>(smem);  // wd, during the prologue
  float2* stats = reinterpret_cast<float2*>(win + window_bytes(CP, k));
  const Bars bars(wins + window_bytes(CP, k) + W * 8,
                  reinterpret_cast<uint32_t*>(win + window_bytes(CP, k) + W * 8 + 16));
  const int b = blockIdx.y, t0 = blockIdx.x * kRows;
  const int nchunks = a.F / kFC;
  const bf16* zb = a.z + static_cast<size_t>(b) * T * C;
  const float* g1 = a.lnp;
  const float* be1 = a.lnp + C;
  const float* g2 = a.lnp + 2 * C;
  const float* be2 = a.lnp + 3 * C;
  const float* bd = a.lnp + 4 * C;
  const float* b2f = a.lnp + 5 * C;
  const int lane = threadIdx.x & 31;
  FFN_CLOCK(tp);

  if (threadIdx.x == 0) bars.init();
  // wd into the weight buffers (free until chunk 0 is issued), beside LN1
  for (int i = 4 * threadIdx.x; i < k * C; i += 4 * ffn::kThreads) cp_async16(base + 4 * i, a.wd + i);
  // 1. LN1 over the window (rows t0 - lpad ..)
  ln1_window(zb, t1p, stats, g1, be1, t0 - lpad, W, T, C, CP, a.eps);
  cp_async_wait_all();
  __syncthreads();

  // 2. depthwise: h0[r][c] = sum_j t1[r + j][c] wd[j][c] + bd[c], rounded,
  //    into the swizzled tile; a work item is 16 rows by 2 channels, taps 8
  //    at a time over a register window of 23 rows
  for (int u = threadIdx.x; u < (kRows / kNR) * (CP / 2); u += ffn::kThreads) {
    const int c = 2 * (u % (CP / 2)), r0 = kNR * (u / (CP / 2));
    float2 acc[kNR];
#pragma unroll
    for (int i = 0; i < kNR; ++i) acc[i] = make_float2(0.0f, 0.0f);
    if (c < C) {
      for (int j0 = 0; j0 < k; j0 += 8) {
        float2 w[8], x[kNR + 7];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          w[jj] = j0 + jj < k ? *reinterpret_cast<const float2*>(wdp + (j0 + jj) * C + c)
                              : make_float2(0.0f, 0.0f);
#pragma unroll
        for (int q = 0; q < kNR + 7; ++q) {
          const int rr = r0 + j0 + q;
          x[q] = rr < W ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(t1p + rr * CP + c))
                        : make_float2(0.0f, 0.0f);
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int i = 0; i < kNR; ++i) {
            acc[i].x += x[i + jj].x * w[jj].x;
            acc[i].y += x[i + jj].y * w[jj].y;
          }
      }
      const float2 bias = *reinterpret_cast<const float2*>(bd + c);
#pragma unroll
      for (int i = 0; i < kNR; ++i) acc[i] = make_float2(acc[i].x + bias.x, acc[i].y + bias.y);
    }
#pragma unroll
    for (int i = 0; i < kNR; ++i) stage_pair(h0p, r0 + i, c, acc[i].x, acc[i].y);
  }
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {  // chunk 0, now that wd has left the weight buffers
    load_w(bars, 0, w1s, a.img, 0, CP);
    load_w(bars, 1, w2s, a.img, 0, CP);
  }
  FFN_PHASE(0, tp);  // prologue

  // consumers: 64 rows each; this thread's rows rl, rl + 8 of the tile
  const int cw = threadIdx.x >> 7;
  const int rl = 64 * cw + 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
  const int c2 = 2 * (lane & 3);
  const bool drop = a.seed != nullptr && a.threshold != 0u;
  const unsigned seed_b = a.seed != nullptr ? lfs2::item_seed(*a.seed, b) : 0u;
  const unsigned thr = a.threshold;
  const float ik = a.inv_keep;
  const unsigned rh[2] = {row_hash(t0 + rl), row_hash(t0 + rl + 8)};
  float ff[CP / 2];
#pragma unroll
  for (int i = 0; i < CP / 2; ++i) ff[i] = 0.0f;

  for (int i = 0; i < nchunks; ++i) {
    const unsigned ph = i & 1;
    float2 bb[8];  // b1 of the thread's columns, loaded while the product runs
#pragma unroll
    for (int j = 0; j < 8; ++j) bb[j] = *reinterpret_cast<const float2*>(a.b1 + i * kFC + 8 * j + c2);
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
    release_w(bars, 0, w1s, a.img, i + 1 < nchunks ? i + 1 : -1, CP);
    // + b1, relu, round; keep1 and scale; rounded into the warpgroup's rows
    // of the up staging
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f = i * kFC + 8 * j + c2;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = lfs2::round_to<bf16>(fmaxf(up[4 * j + e] + pick(bb[j], e), 0.0f));
        if (drop) v[e] = keep_h(rh[e >> 1], col_hash(f + (e & 1), 1u), seed_b, thr) ? v[e] * ik : 0.0f;
      }
      stage_pair(win, rl, 8 * j + c2, v[0], v[1]);
      stage_pair(win, rl + 8, 8 * j + c2, v[2], v[3]);
    }
    fence_proxy_async();
    wg_sync(1 + cw);  // the warpgroup's rows are staged
    FFN_PHASE(3, tp);  // up epilogue
    mbar_wait(bars.full2, ph);
    FFN_PHASE(4, tp);  // waiting for W2
    wgmma_fence();
    {
      const uint32_t sd = opaque(desc(wins)), w2d = opaque(desc(w2s, 64 * 128));
#pragma unroll
      for (int s = 0; s < 4; ++s)
        SsOp<CP>::template run<0, 1>(ff, kmajor(sd, kRows, 64 * cw, s), mnmajor(w2d, s), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    hold(ff);
    FFN_PHASE(5, tp);  // ff product
    release_w(bars, 1, w2s, a.img, i + 1 < nchunks ? i + 1 : -1, CP);
  }

  // the epilogue, row by row: first the warpgroups' ff + b2f (keep2 and
  // scale) into an f32 row buffer over the weight buffers, h0 and the window
  // (free once both warpgroups left the loop; the chain stores its h0 rows
  // before), then each row on C / 8 lanes of 8 channels
  if constexpr (kChain)  // the warpgroup's h0 rows, for the dup pass
    store_tile(h0p, a.h0_out + (static_cast<size_t>(b) * T + t0) * C, 64 * cw,
               min(64 * cw + 64, T - t0), C, threadIdx.x & 127, 128);
  named_sync(7);
  float* rows = reinterpret_cast<float*>(smem);
  constexpr int RLD = CP + 4;  // row stride (floats): 2-way bank conflicts at most
#pragma unroll
  for (int j = 0; j < CP / 8; ++j) {
    const int c = 8 * j + c2;
    if (c >= C) continue;
    const float2 bb = *reinterpret_cast<const float2*>(b2f + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        v[e] = ff[4 * j + 2 * h + e] + pick(bb, e);
        if (drop) v[e] = keep_h(rh[h], col_hash(c + e, 2u), seed_b, thr) ? v[e] * ik : 0.0f;
      }
      *reinterpret_cast<float2*>(rows + (rl + 8 * h) * RLD + c) = make_float2(v[0], v[1]);
    }
  }
  named_sync(7);
  FFN_PHASE(6, tp);  // ff into the row buffer
  const int G = C / 8, rpw = 32 / G, l = lane % G, c = 8 * l;
  float gv1[8], bv1[8], gv2[8], bv2[8];
  lfs2::load_vec<8>(g1 + c, gv1);
  lfs2::load_vec<8>(be1 + c, bv1);
  lfs2::load_vec<8>(g2 + c, gv2);
  lfs2::load_vec<8>(be2 + c, bv2);
  float cg[8], cb[8], cf[8];  // the chain's column sums: dg2, dbe2, db2f
#pragma unroll
  for (int e = 0; e < 8; ++e) cg[e] = cb[e] = cf[e] = 0.0f;
  // a lane forms two rows a pass (rows r and r + step: two independent
  // reduction chains), the next pass's z and dout in flight; zero past T
  const int step = 8 * rpw;
  auto load = [&](int r, uint4& zr, uint4& dr) {
    const int g = t0 + r;
    const size_t at = (static_cast<size_t>(b) * T + g) * C + c;
    const bool in = r < kRows && g < T;
    zr = in ? *reinterpret_cast<const uint4*>(a.z + at) : make_uint4(0u, 0u, 0u, 0u);
    if constexpr (kChain) dr = in ? *reinterpret_cast<const uint4*>(a.dout + at) : make_uint4(0u, 0u, 0u, 0u);
  };
  auto unpack = [](const uint4& raw, float (&x)[8]) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(p[e]);
      x[2 * e] = f.x;
      x[2 * e + 1] = f.y;
    }
  };
  const int first = (threadIdx.x >> 5) * rpw + lane / G;
  uint4 zn[2], dn[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) load(first + h * step, zn[h], dn[h]);
  for (int r0 = first; r0 < kRows; r0 += 2 * step) {
    uint4 zr[2], dq[2];
    float v[2][8], s[2], s2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      zr[h] = zn[h];
      dq[h] = dn[h];
      load(r0 + (2 + h) * step, zn[h], dn[h]);
      const int r = r0 + h * step;
      lfs2::load_vec<8>(rows + r * RLD + c, v[h]);
      if (t0 + r < T) {
        // res = t1 + ff, with t1 formed again from z and LN1's row statistics
        const float2 st = stats[r + lpad];
        float zv[8];
        unpack(zr[h], zv);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[h][e] += lfs2::round_to<bf16>(ln_apply(zv[e], st.x, st.y, gv1[e], bv1[e]));
      }
      s[h] = s2[h] = 0.0f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s[h] += v[h][e];
        s2[h] += v[h][e] * v[h][e];
      }
    }
    for (int m = G / 2; m > 0; m >>= 1)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[h] += __shfl_xor_sync(0xffffffffu, s[h], m);
        s2[h] += __shfl_xor_sync(0xffffffffu, s2[h], m);
      }
    float mean[2], inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mean[h] = s[h] / C;
      inv[h] = rsqrtf(fmaxf(s2[h] / C - mean[h] * mean[h], 0.0f) + a.eps);
    }
    if constexpr (!kChain) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g = t0 + r0 + h * step;
        if (g >= T) continue;
        uint4 o;
        uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          op[e] = pack_bf16(ln_apply(v[h][2 * e], mean[h], inv[h], gv2[2 * e], bv2[2 * e]),
                            ln_apply(v[h][2 * e + 1], mean[h], inv[h], gv2[2 * e + 1], bv2[2 * e + 1]));
        *reinterpret_cast<uint4*>(a.out + (static_cast<size_t>(b) * T + g) * C + c) = o;
      }
    } else {
      // the LN2 backward from dout (zero on rows >= T): dres = inv (dy g2 -
      // mean(dy g2) - x_hat mean(dy g2 x_hat)), dff = keep2 dres / (1 - r)
      float dy[2][8], m1[2], m2[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unpack(dq[h], dy[h]);
        m1[h] = m2[h] = 0.0f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[h][e] = (v[h][e] - mean[h]) * inv[h];  // x_hat
          const float dyg = dy[h][e] * gv2[e];
          m1[h] += dyg;
          m2[h] += dyg * v[h][e];
          cg[e] += dy[h][e] * v[h][e];
          cb[e] += dy[h][e];
        }
      }
      for (int m = G / 2; m > 0; m >>= 1)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          m1[h] += __shfl_xor_sync(0xffffffffu, m1[h], m);
          m2[h] += __shfl_xor_sync(0xffffffffu, m2[h], m);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g = t0 + r0 + h * step;
        const unsigned rhg = row_hash(g);
        float dr[8], df[8];
        uint4 o;
        uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          dr[e] = inv[h] * (dy[h][e] * gv2[e] - m1[h] / C - v[h][e] * (m2[h] / C));
          df[e] = drop && !keep_h(rhg, col_hash(c + e, 2u), seed_b, thr) ? 0.0f : dr[e] * ik;
          cf[e] += df[e];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) op[e] = pack_bf16(df[2 * e], df[2 * e + 1]);
        if (g < T) {
          const size_t at = (static_cast<size_t>(b) * T + g) * C + c;
          *reinterpret_cast<float4*>(a.dres_out + at) = make_float4(dr[0], dr[1], dr[2], dr[3]);
          *reinterpret_cast<float4*>(a.dres_out + at + 4) = make_float4(dr[4], dr[5], dr[6], dr[7]);
          *reinterpret_cast<uint4*>(a.dff_out + at) = o;
        }
      }
    }
  }
  if constexpr (kChain) {
    // the column sums over the warp's rows (lanes of equal l), then added
    // into dvec by the warp's first row of lanes
#pragma unroll
    for (int e = 0; e < 8; ++e)
      for (int m = G; m < 32; m <<= 1) {
        cg[e] += __shfl_xor_sync(0xffffffffu, cg[e], m);
        cb[e] += __shfl_xor_sync(0xffffffffu, cb[e], m);
        cf[e] += __shfl_xor_sync(0xffffffffu, cf[e], m);
      }
    if (lane < G) {
      float* dv = a.dvec + c;
#pragma unroll
      for (int e = 0; e < 8; e += 4) {
        atomicAdd(reinterpret_cast<float4*>(dv + 2 * C + e), make_float4(cg[e], cg[e + 1], cg[e + 2], cg[e + 3]));
        atomicAdd(reinterpret_cast<float4*>(dv + 3 * C + e), make_float4(cb[e], cb[e + 1], cb[e + 2], cb[e + 3]));
        atomicAdd(reinterpret_cast<float4*>(dv + 5 * C + e), make_float4(cf[e], cf[e + 1], cf[e + 2], cf[e + 3]));
      }
    }
  }
  FFN_PHASE(7, tp);  // LN2 rows
  FFN_FLUSH();
}

template <int CP, bool kChain>
cudaError_t bf16_launch(const FwdArgs& a, int B, cudaStream_t stream) {
  const int smem = ffn::fwd_smem(CP, a.k);
  if (a.k < 1 || smem > ffn::kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = ffn_ln_kernel<CP, kChain>;
  cudaError_t err = lfs2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + ffn::kRows - 1) / ffn::kRows, B);
  kernel<<<grid, ffn::kThreads, smem, stream>>>(a);
  return record_launch(grid, smem, ffn::kRows);
}

template <bool kChain>
cudaError_t bf16_dispatch(const FwdArgs& a, int B, cudaStream_t s) {
  switch (a.C) {
    case 32:
    case 64: return bf16_launch<64, kChain>(a, B, s);
    case 128: return bf16_launch<128, kChain>(a, B, s);
    case 256: return bf16_launch<256, kChain>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_shape(int B, int T_len, int F, int k) {
  return F % kFChunk != 0 || k < 1 || B < 1 || T_len < 1;
}

FwdArgs bf16_args(const void* z, const float* wd, const void* img, const float* b1,
                  const float* lnp, const int* seed, int T_len, int C, int F, int k, float eps,
                  unsigned threshold, float inv_keep) {
  FwdArgs a{};
  a.z = static_cast<const bf16*>(z);
  a.wd = wd;
  a.img = static_cast<const uint8_t*>(img);
  a.b1 = b1;
  a.lnp = lnp;
  a.seed = seed;
  a.T = T_len;
  a.C = C;
  a.F = F;
  a.k = k;
  a.eps = eps;
  a.threshold = threshold;
  a.inv_keep = inv_keep;
  return a;
}

}  // namespace

LFS2_DEFINE_ERROR_STRING

// bf16 reads the weights from img (ops/ffn.py _weight_image), f32 from w1
// and w2f
LFS2_EXPORT int lfs2_ffn_ln(const void* z, void* out, const float* wd, const void* w1,
                            const float* b1, const void* w2f, const float* lnp, const void* img,
                            int B, int T_len, int C, int F, int k, float eps, int dtype,
                            void* stream) {
  if (bad_shape(B, T_len, F, k)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfs2::kBF16) {
    FwdArgs a = bf16_args(z, wd, img, b1, lnp, nullptr, T_len, C, F, k, eps, 0u, 1.0f);
    a.out = static_cast<bf16*>(out);
    return static_cast<int>(bf16_dispatch<false>(a, B, s));
  }
  const Drop d{nullptr, 0u, 1.0f};
  return static_cast<int>(f32_dispatch<false>(C, z, out, wd, w1, b1, w2f, lnp, B, T_len, F, k, eps, d, s));
}

// seed: one int32 on the device; threshold and inv_keep from the rate
LFS2_EXPORT int lfs2_ffn_ln_train(const void* z, void* out, const float* wd, const void* w1,
                                  const float* b1, const void* w2f, const float* lnp,
                                  const void* img, const int* seed, int B, int T_len, int C,
                                  int F, int k, float eps, unsigned threshold, float inv_keep,
                                  int dtype, void* stream) {
  if (bad_shape(B, T_len, F, k)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfs2::kBF16) {
    FwdArgs a = bf16_args(z, wd, img, b1, lnp, seed, T_len, C, F, k, eps, threshold, inv_keep);
    a.out = static_cast<bf16*>(out);
    return static_cast<int>(bf16_dispatch<false>(a, B, s));
  }
  const Drop d{seed, threshold, inv_keep};
  return static_cast<int>(f32_dispatch<true>(C, z, out, wd, w1, b1, w2f, lnp, B, T_len, F, k, eps, d, s));
}

// The bf16 backward's stage (a): the forward again with the LN2 backward
// from dout; writes h0, dres (f32), dff (bf16), all (B, T, C), and adds
// dg2, dbe2 and db2f into dvec (6, C), a zeroed f32 buffer
LFS2_EXPORT int lfs2_ffn_ln_chain(const void* z, const void* dout, const float* wd,
                                  const void* img, const float* b1, const float* lnp,
                                  const int* seed, void* h0, float* dres, void* dff, float* dvec,
                                  int B, int T_len, int C, int F, int k, float eps,
                                  unsigned threshold, float inv_keep, void* stream) {
  if (bad_shape(B, T_len, F, k)) return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a = bf16_args(z, wd, img, b1, lnp, seed, T_len, C, F, k, eps, threshold, inv_keep);
  a.dout = static_cast<const bf16*>(dout);
  a.h0_out = static_cast<bf16*>(h0);
  a.dres_out = dres;
  a.dff_out = static_cast<bf16*>(dff);
  a.dvec = dvec;
  return static_cast<int>(bf16_dispatch<true>(a, B, static_cast<cudaStream_t>(stream)));
}

#ifdef LFS2_FFN_PHASE_CLOCKS
// copies out and zeroes block (0, 0)'s phase cycles, [warpgroup][slot]
LFS2_EXPORT int lfs2_ffn_ln_phase_clocks(long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, ffn::g_phase, sizeof(ffn::g_phase));
  static const long long zero[2][16] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(ffn::g_phase, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif

// copies into out[0..4] the grid (x, y, z), shared-memory bytes and rows a
// block owns of the latest accepted launch; zeros before the first
LFS2_EXPORT int lfs2_ffn_ln_last_launch(int* out) {
  for (int i = 0; i < 5; ++i) out[i] = g_last_launch[i];
  return 0;
}

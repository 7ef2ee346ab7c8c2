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
// f32 route (ffn_tf32_kernel): the products on the tensor cores as split
// TF32 (a b = a_hi b_lo + a_lo b_hi + a_hi b_hi, mma.sync m16n8k8), which
// keeps f32's digits at a third of TF32's rate (165 TFLOP/s against the
// CUDA cores' 67). A block owns 64 rows, or 32 where 64 would leave most
// of the card idle (ffn_plan), with eight warps; F streams in chunks of 32
// columns, a W1 and a W2f piece each, split and in fragment order
// (ops/ffn.py _f32_image), one bulk copy each, through two buffers that the
// last warp to release refills. h0 is an f32 tile split as it is read; the
// up chunk's accumulators become the ff product's A fragments as they
// stand (ffn_sm90.cuh's k order), split once into shared memory. Every
// product sums at most 64 k indices on the tensor cores and adds them in
// f32 (their accumulation truncates). The epilogue runs a row on a warp;
// the chain variant writes h0, dres and dff in f32.
//
// Serving at C = 384, 512 and 640 (ffn_wide_kernel, below): 32-row blocks
// with C split across the eight warps, both dtypes on mma.sync, the weights'
// fragments read from L2.
//
// Shapes the kernel takes: C in {32, 64, 128, 256} (serving and training)
// and {384, 512, 640} (serving), F a multiple of 128, any T >= 1; k >= 1
// while the t1 window fits shared memory (k <= 63 at C = 256 in bf16;
// rows + k - 1 <= 128 in f32; k <= 27 at C = 640 in f32).
#include "common.cuh"
#include "ffn_sm90.cuh"

namespace {

constexpr int kFChunk = 128;  // F must be a multiple of this

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

// ============================ f32 route: split TF32 =========================
struct F32Args {
  const float* z;
  float* out;          // serve / train: the output
  const float* dout;   // chain: the output's gradient
  const float* wd;
  const float* img;    // F / 32 chunks of a W1 and a W2f piece (ops/ffn.py _f32_image)
  const float* b1;
  const float* lnp;
  const int* seed;     // null: no dropout
  float* h0_out;       // chain: h0, dres, dff (B, T, C) and the (6, C) partials
  float* dres_out;
  float* dff_out;
  float* dvec;
  int T, F, k;
  float eps;
  unsigned threshold;
  float inv_keep;
};

// LN1 over the W window rows (item rows t_first ..) into t1 (f32, C a row;
// zero outside [0, T)), and each row's mean and 1 / sigma; C / 8 lanes a
// row, 8 channels a lane
template <int C>
__device__ __forceinline__ void ln1_window_f32(const float* __restrict__ zb, float* t1,
                                               float2* stats, const float* __restrict__ g1,
                                               const float* __restrict__ be1, int t_first, int W,
                                               int T, float eps) {
  constexpr int G = C / 8, RPW = 32 / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, l = lane % G;
  float gv[8], bv[8];
  lfs2::load_vec<8>(g1 + 8 * l, gv);
  lfs2::load_vec<8>(be1 + 8 * l, bv);
  for (int r0 = warp * RPW; r0 < W; r0 += (ffn::kThreads / 32) * RPW) {
    const int r = r0 + lane / G, g = t_first + r;
    const bool in = r < W && g >= 0 && g < T;
    float v[8], s = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = 0.0f;
    if (in) lfs2::load_vec<8>(zb + static_cast<size_t>(g) * C + 8 * l, v);
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
    const float mean = s / C;
    const float inv = rsqrtf(fmaxf(s2 / C - mean * mean, 0.0f) + eps);
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = in ? ffn::ln_apply(v[e], mean, inv, gv[e], bv[e]) : 0.0f;
    *reinterpret_cast<float4*>(t1 + r * C + 8 * l) = make_float4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<float4*>(t1 + r * C + 8 * l + 4) = make_float4(o[4], o[5], o[6], o[7]);
    if (l == 0) stats[r] = make_float2(mean, inv);
  }
}

// ffn_tf32_kernel<C, MT, kChain>: a block owns R = 32 MT rows of one item;
// kChain false serves and trains (dropout when a seed is given and the rate
// is not 0), true is the backward's chain. Eight warps: per F chunk of 32,
//   up (R x 32) = h0 @ W1 piece      warps 4 x 2 (R = 64) or 2 x 4 (R = 32)
//                                    of 16 rows, h0 split as it is read
//   + b1, relu, keep1 and scale, split into the ff product's A fragments
//   ff (R x C) += up @ W2f piece     warps 2 x 4 of R / 2 rows by C / 4
// Each piece is one bulk copy into its buffer, the next issued by the last
// warp to release the buffer; the up staging has two buffers, so one block
// barrier a chunk guards it.
template <int C, int MT, bool kChain>
__global__ void __launch_bounds__(ffn::kThreads, 1)
ffn_tf32_kernel(const __grid_constant__ F32Args a) {
  using namespace ffn;
  constexpr int R = 32 * MT, FC = kF32FC, P = piece_bytes(C, FC);
  constexpr int WMU = R / 16, WNU = 8 / WMU, NTU = FC / 8 / WNU;  // up: warps down, across; n8 tiles
  constexpr int NT = C / 32;                                     // ff: n8 tiles a warp
  constexpr int kNR = 16;                                        // depthwise rows a work item
  extern __shared__ __align__(16) uint8_t smem[];
  const int k = a.k, T = a.T, lpad = (k - 1) / 2, W = R + k - 1;
  float* t1 = reinterpret_cast<float*>(smem);  // the window, over the piece buffers
  float* h0s = reinterpret_cast<float*>(smem + 2 * P);
  float4* ups = reinterpret_cast<float4*>(smem + 2 * P + R * C * 4);
  uint8_t* barp = smem + 2 * P + R * C * 4 + 2 * R * FC * 8;
  float2* stats = reinterpret_cast<float2*>(barp + kBarBytes);
  const float4* wb1 = reinterpret_cast<const float4*>(smem);
  const float4* wb2 = reinterpret_cast<const float4*>(smem + P);
  const uint32_t base = smem_u32(smem);
  const Bars bars(smem_u32(barp), reinterpret_cast<uint32_t*>(barp + 16));
  const int b = blockIdx.y, t0 = blockIdx.x * R;
  const int nchunks = a.F / FC;
  const float* zb = a.z + static_cast<size_t>(b) * T * C;
  const float* g1 = a.lnp;
  const float* be1 = a.lnp + C;
  const float* g2 = a.lnp + 2 * C;
  const float* be2 = a.lnp + 3 * C;
  const float* bd = a.lnp + 4 * C;
  const float* b2f = a.lnp + 5 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint8_t* img = reinterpret_cast<const uint8_t*>(a.img);
  auto piece = [img](int ci, int m) { return img + (static_cast<size_t>(ci) * 2 + m) * P; };

  if (threadIdx.x == 0) bars.init();
  // 1. LN1 over the window (rows t0 - lpad ..)
  ln1_window_f32<C>(zb, t1, stats, g1, be1, t0 - lpad, W, T, a.eps);
  __syncthreads();

  // 2. depthwise: h0[r][c] = sum_j t1[r + j][c] wd[j][c] + bd[c], into the
  //    swizzled tile; a work item is 16 rows by 2 channels, taps 8 at a time
  //    over a register window of 23 rows
  for (int u = threadIdx.x; u < (R / kNR) * (C / 2); u += ffn::kThreads) {
    const int c = 2 * (u % (C / 2)), r0 = kNR * (u / (C / 2));
    float2 acc[kNR];
#pragma unroll
    for (int i = 0; i < kNR; ++i) acc[i] = make_float2(0.0f, 0.0f);
    for (int j0 = 0; j0 < k; j0 += 8) {
      float2 w[8], x[kNR + 7];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        w[jj] = j0 + jj < k ? __ldg(reinterpret_cast<const float2*>(a.wd + (j0 + jj) * C + c))
                            : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int q = 0; q < kNR + 7; ++q) {
        const int rr = r0 + j0 + q;
        x[q] = rr < W ? *reinterpret_cast<const float2*>(t1 + rr * C + c) : make_float2(0.0f, 0.0f);
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
    for (int i = 0; i < kNR; ++i)
      *reinterpret_cast<float2*>(h0s + (r0 + i) * C + swz32(r0 + i, c)) =
          make_float2(acc[i].x + bias.x, acc[i].y + bias.y);
  }
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {  // chunk 0, now that the window has left the buffers
    load_bytes(bars, 0, base, piece(0, 0), P);
    load_bytes(bars, 1, base + P, piece(0, 1), P);
  }

  const int um = warp % WMU, un = warp / WMU;  // up warp: rows 16 um, n8 tiles un NTU
  const int fm = warp >> 2, fn = warp & 3;     // ff warp: m16 tiles fm MT, n8 tiles fn NT
  const bool drop = a.seed != nullptr && a.threshold != 0u;
  const unsigned seed_b = a.seed != nullptr ? lfs2::item_seed(*a.seed, b) : 0u;
  const unsigned thr = a.threshold;
  const float ik = a.inv_keep;
  const unsigned rh[2] = {row_hash(t0 + 16 * um + g), row_hash(t0 + 16 * um + g + 8)};
  float ff[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ff[mt][nt][e] = 0.0f;

  for (int i = 0; i < nchunks; ++i) {
    const unsigned ph = i & 1;
    float up[NTU][4];
    mbar_wait(bars.full1, ph);
    rows_x_piece<C, NTU, FC / 8>(up, h0s, 16 * um, wb1, un * NTU, lane);
    if (last_of(&bars.released[0], 8) && i + 1 < nchunks) load_bytes(bars, 0, base, piece(i + 1, 0), P);
    // + b1, relu, keep1 and scale into staging buffer i % 2 (every warp
    // read buffer (i - 2) % 2 before the last chunk's barrier); tile j of
    // the chunk is the ff product's k-step j
    float4* stage = ups + (i & 1) * (R * FC / 2);
#pragma unroll
    for (int nt = 0; nt < NTU; ++nt) {
      const int j = un * NTU + nt, f = i * FC + 8 * j + 2 * t;
      const float2 bb = *reinterpret_cast<const float2*>(a.b1 + f);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = fmaxf(up[nt][e] + ((e & 1) ? bb.y : bb.x), 0.0f);
        if (drop) v[e] = keep_h(rh[e >> 1], col_hash(f + (e & 1), 1u), seed_b, thr) ? v[e] * ik : 0.0f;
      }
      store_a_frag(stage + ((j * (R / 16) + um) * 32 + lane) * 2, v);
    }
    __syncthreads();  // the chunk's up staging is complete
    mbar_wait(bars.full2, ph);
    frags_x_piece<MT, NT, FC / 8, R / 16, C / 8>(ff, stage, fm * MT, wb2, fn * NT, lane);
    if (last_of(&bars.released[1], 8) && i + 1 < nchunks) load_bytes(bars, 1, base + P, piece(i + 1, 1), P);
  }

  // the epilogue, row by row: ff + b2f (keep2 and scale) into an f32 row
  // buffer over the piece buffers (free once every warp left the loop; the
  // chain stores its h0 rows to device memory first), then each row on one
  // warp
  if constexpr (kChain) {
    float* dst = a.h0_out + (static_cast<size_t>(b) * T + t0) * C;
    for (int idx = threadIdx.x; idx < R * (C / 4); idx += ffn::kThreads) {
      const int r = idx / (C / 4), c = 4 * (idx % (C / 4));
      if (t0 + r < T)
        *reinterpret_cast<float4*>(dst + static_cast<size_t>(r) * C + c) =
            *reinterpret_cast<const float4*>(h0s + r * C + swz32(r, c));
    }
  }
  __syncthreads();
  constexpr int RLD = C + 4;
  float* rows = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = 8 * (fn * NT + nt) + 2 * t;
      const float2 bb = *reinterpret_cast<const float2*>(b2f + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * (fm * MT + mt) + g + 8 * h;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = ff[mt][nt][2 * h + e] + (e ? bb.y : bb.x);
          if (drop) v[e] = keep_h(row_hash(t0 + r), col_hash(c + e, 2u), seed_b, thr) ? v[e] * ik : 0.0f;
        }
        *reinterpret_cast<float2*>(rows + r * RLD + c) = make_float2(v[0], v[1]);
      }
    }
  __syncthreads();
  constexpr int NC = C / 32;  // channels lane + 32 i of a row
  float cg[NC], cb[NC], cf[NC];  // the chain's column sums: dg2, dbe2, db2f
#pragma unroll
  for (int i = 0; i < NC; ++i) cg[i] = cb[i] = cf[i] = 0.0f;
  for (int r = warp; r < R && t0 + r < T; r += ffn::kThreads / 32) {
    const int gr = t0 + r;
    const size_t at = (static_cast<size_t>(b) * T + gr) * C;
    const float2 st = stats[r + lpad];
    float v[NC], s = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      // res = t1 + ff, with t1 formed again from z and LN1's row statistics
      v[i] = rows[r * RLD + c] + ln_apply(a.z[at + c], st.x, st.y, g1[c], be1[c]);
      s += v[i];
      s2 += v[i] * v[i];
    }
    s = lfs2::warp_sum(s);
    s2 = lfs2::warp_sum(s2);
    const float mean = s / C;
    const float inv = rsqrtf(fmaxf(s2 / C - mean * mean, 0.0f) + a.eps);
    if constexpr (!kChain) {
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = lane + 32 * i;
        a.out[at + c] = ln_apply(v[i], mean, inv, g2[c], be2[c]);
      }
    } else {
      // the LN2 backward from dout: dres = inv (dy g2 - mean(dy g2) - x_hat
      // mean(dy g2 x_hat)), dff = keep2 dres / (1 - r)
      float dy[NC], m1 = 0.0f, m2 = 0.0f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = lane + 32 * i;
        dy[i] = a.dout[at + c];
        v[i] = (v[i] - mean) * inv;  // x_hat
        const float dyg = dy[i] * g2[c];
        m1 += dyg;
        m2 += dyg * v[i];
      }
      m1 = lfs2::warp_sum(m1) / C;
      m2 = lfs2::warp_sum(m2) / C;
      const unsigned rhg = row_hash(gr);
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = lane + 32 * i;
        const float dr = inv * (dy[i] * g2[c] - m1 - v[i] * m2);
        const float df = drop && !keep_h(rhg, col_hash(c, 2u), seed_b, thr) ? 0.0f : dr * ik;
        a.dres_out[at + c] = dr;
        a.dff_out[at + c] = df;
        cg[i] += dy[i] * v[i];
        cb[i] += dy[i];
        cf[i] += df;
      }
    }
  }
  if constexpr (kChain) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      atomicAdd(a.dvec + 2 * C + c, cg[i]);
      atomicAdd(a.dvec + 3 * C + c, cb[i]);
      atomicAdd(a.dvec + 5 * C + c, cf[i]);
    }
  }
}

template <int C, int MT, bool kChain>
cudaError_t f32_launch(const F32Args& a, int B, cudaStream_t stream) {
  const int smem = ffn::f32_fwd_smem(32 * MT, C, a.k);
  if (a.k < 1 || smem > ffn::kMaxSmem || 32 * MT + a.k - 1 > 2 * ffn::kF32FC * 8 / 4)
    return cudaErrorInvalidValue;
  auto kernel = ffn_tf32_kernel<C, MT, kChain>;
  cudaError_t err = lfs2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + 32 * MT - 1) / (32 * MT), B);
  kernel<<<grid, ffn::kThreads, smem, stream>>>(a);
  return record_launch(grid, smem, 32 * MT);
}

template <int C, bool kChain>
cudaError_t f32_rows(const F32Args& a, int B, int rows, cudaStream_t s) {
  switch (rows) {
    case 32: return f32_launch<C, 1, kChain>(a, B, s);
    case 64: return f32_launch<C, 2, kChain>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kChain>
cudaError_t f32_dispatch(int C, const F32Args& a, int B, int rows, cudaStream_t s) {
  switch (C) {
    case 32: return f32_rows<32, kChain>(a, B, rows, s);
    case 64: return f32_rows<64, kChain>(a, B, rows, s);
    case 128: return f32_rows<128, kChain>(a, B, rows, s);
    case 256: return f32_rows<256, kChain>(a, B, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

F32Args f32_args(const void* z, const float* wd, const void* img, const float* b1,
                 const float* lnp, const int* seed, int T_len, int F, int k, float eps,
                 unsigned threshold, float inv_keep) {
  F32Args a{};
  a.z = static_cast<const float*>(z);
  a.wd = wd;
  a.img = static_cast<const float*>(img);
  a.b1 = b1;
  a.lnp = lnp;
  a.seed = seed;
  a.T = T_len;
  a.F = F;
  a.k = k;
  a.eps = eps;
  a.threshold = threshold;
  a.inv_keep = inv_keep;
  return a;
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

// ===================== serving at C = 384, 512, 640: both dtypes =====================
// ffn_wide_kernel<T, C>: a block owns kWideRows = 32 rows of one item with
// eight warps, and C is split across them, so a thread holds 32 x C / 256 f32
// ff values (80 at C = 640) where the kernels above would need C / 2. The
// weights do not fit shared memory beside the t1 window at these widths
// (a 64-column chunk of W1 and W2f is 160 KB in bf16 at C = 640), so every
// warp reads its B fragments straight from device memory (L2), in fragment
// order: per chunk of 32 F columns a W1 piece (K = C, N = 32) and a W2f piece
// (K = 32, N = C). bf16 runs mma.sync m16n8k16 on pieces of ops/ffn.py
// _wide_image; f32 the split-TF32 products of the f32 route above on
// _f32_image's pieces. Shared memory holds the t1 window (f32, the working
// dtype's values), h0 and the up chunk's staging (two buffers, one block
// barrier a chunk); per chunk:
//   up (32 x 32) = h0 @ W1 piece   warps 2 x 4 of 16 rows by one n8 tile
//   + b1, relu, round, into the staging
//   ff (32 x C) += up @ W2f piece  warps 2 x 4 of 16 rows by C / 4 columns
// The epilogue is the f32 route's: ff + b2f into an f32 row buffer over the
// window, then LN2 a row a warp with t1 formed again from z.
constexpr int kWideRows = 32;
constexpr int kWideFC = 32;

template <typename T> struct WideArgs {
  const T* z;
  T* out;
  const float* wd;
  const uint8_t* img;
  const float* b1;
  const float* lnp;
  int T_len, F, k;
  float eps;
};

// h0 row stride (elements): f32 rows of C, columns swizzled (swz32); bf16
// rows of C + 8, so that a fragment's 32-bit reads meet 32 banks
template <typename T, int C> __host__ __device__ constexpr int wide_hld() {
  return sizeof(T) == 4 ? C : C + 8;
}
constexpr int kWideStageLd = kWideFC + 8;  // bf16 up staging row stride
template <typename T, int C> __host__ __device__ constexpr int wide_stage_bytes() {
  return sizeof(T) == 4 ? kWideRows * kWideFC * 8 : kWideRows * kWideStageLd * 2;
}
// one region that is the t1 window (prologue), the two up stagings (loop)
// and the f32 row buffer (epilogue)
template <typename T, int C> __host__ __device__ constexpr int wide_region(int k) {
  const int win = (kWideRows + k - 1) * C * 4, rows = kWideRows * (C + 4) * 4;
  const int stage = 2 * wide_stage_bytes<T, C>();
  return win > rows ? (win > stage ? win : stage) : (rows > stage ? rows : stage);
}
// h0, the region, each window row's LN1 statistics
template <typename T, int C> __host__ __device__ constexpr int wide_smem(int k) {
  return kWideRows * wide_hld<T, C>() * static_cast<int>(sizeof(T)) + wide_region<T, C>(k) +
         (kWideRows + k - 1) * 8;
}
// one chunk's W1 or W2f piece: C * 32 values, f32 as hi and lo
template <typename T, int C> __host__ __device__ constexpr int wide_piece_bytes() {
  return sizeof(T) == 4 ? C * kWideFC * 8 : C * kWideFC * 2;
}

template <typename T, int C>
__global__ void __launch_bounds__(ffn::kThreads, 1)
ffn_wide_kernel(const __grid_constant__ WideArgs<T> a) {
  using namespace ffn;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int R = kWideRows, FC = kWideFC, HLD = wide_hld<T, C>();
  constexpr int NT = C / 32;    // ff: n8 tiles a warp
  constexpr int NC = C / 32;    // channels lane + 32 i of a row
  constexpr int kNR = 16;       // depthwise rows a work item
  constexpr int PB = wide_piece_bytes<T, C>();
  extern __shared__ __align__(16) uint8_t smem[];
  const int k = a.k, T_len = a.T_len, lpad = (k - 1) / 2, W = R + k - 1;
  T* h0 = reinterpret_cast<T*>(smem);
  uint8_t* region = smem + R * HLD * sizeof(T);
  float* t1 = reinterpret_cast<float*>(region);
  float2* stats = reinterpret_cast<float2*>(region + wide_region<T, C>(k));
  const int b = blockIdx.y, t0 = blockIdx.x * R;
  const int nchunks = a.F / FC;
  const T* zb = a.z + static_cast<size_t>(b) * T_len * C;
  const float* g1 = a.lnp;
  const float* be1 = a.lnp + C;
  const float* g2 = a.lnp + 2 * C;
  const float* be2 = a.lnp + 3 * C;
  const float* bd = a.lnp + 4 * C;
  const float* b2f = a.lnp + 5 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  // 1. LN1 over the window (rows t0 - lpad ..), a row a warp, rounded to T
  for (int r = warp; r < W; r += ffn::kThreads / 32) {
    const int gr = t0 - lpad + r;
    const bool in = gr >= 0 && gr < T_len;
    float v[NC], s = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      v[i] = in ? lfs2::to_f(zb[static_cast<size_t>(gr) * C + lane + 32 * i]) : 0.0f;
      s += v[i];
      s2 += v[i] * v[i];
    }
    s = lfs2::warp_sum(s);
    s2 = lfs2::warp_sum(s2);
    const float mean = s / C;
    const float inv = rsqrtf(fmaxf(s2 / C - mean * mean, 0.0f) + a.eps);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      t1[r * C + c] = in ? lfs2::round_to<T>(ln_apply(v[i], mean, inv, g1[c], be1[c])) : 0.0f;
    }
    if (lane == 0) stats[r] = make_float2(mean, inv);
  }
  __syncthreads();

  // 2. depthwise: h0[r][c] = sum_j t1[r + j][c] wd[j][c] + bd[c], rounded to
  //    T; a work item is 16 rows by 2 channels, taps 8 at a time
  for (int u = threadIdx.x; u < (R / kNR) * (C / 2); u += ffn::kThreads) {
    const int c = 2 * (u % (C / 2)), r0 = kNR * (u / (C / 2));
    float2 acc[kNR];
#pragma unroll
    for (int i = 0; i < kNR; ++i) acc[i] = make_float2(0.0f, 0.0f);
    for (int j0 = 0; j0 < k; j0 += 8) {
      float2 w[8], x[kNR + 7];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        w[jj] = j0 + jj < k ? __ldg(reinterpret_cast<const float2*>(a.wd + (j0 + jj) * C + c))
                            : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int q = 0; q < kNR + 7; ++q) {
        const int rr = r0 + j0 + q;
        x[q] = rr < W ? *reinterpret_cast<const float2*>(t1 + rr * C + c) : make_float2(0.0f, 0.0f);
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
    for (int i = 0; i < kNR; ++i) {
      const float hx = acc[i].x + bias.x, hy = acc[i].y + bias.y;
      if constexpr (kF32)
        *reinterpret_cast<float2*>(h0 + (r0 + i) * C + swz32(r0 + i, c)) = make_float2(hx, hy);
      else
        *reinterpret_cast<uint32_t*>(h0 + (r0 + i) * HLD + c) = pack_bf16(hx, hy);
    }
  }
  __syncthreads();  // h0 is complete and the window is free for the staging

  const int um = warp & 1, un = warp >> 1;   // up warp: rows 16 um, n8 tile un
  const int fm = warp >> 2, fn = warp & 3;   // ff warp: rows 16 fm, n8 tiles fn NT ..
  float ff[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) ff[nt][e] = 0.0f;

  for (int i = 0; i < nchunks; ++i) {
    const uint8_t* w1p = a.img + (static_cast<size_t>(i) * 2) * PB;
    const uint8_t* w2p = w1p + PB;
    uint8_t* stage = region + (i & 1) * wide_stage_bytes<T, C>();
    float up[4];
    if constexpr (kF32) {
      float upt[1][4];
      rows_x_piece<C, 1, FC / 8>(upt, reinterpret_cast<const float*>(h0), 16 * um,
                                 reinterpret_cast<const float4*>(w1p), un, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) up[e] = upt[0][e];
    } else {
      // two accumulators (even and odd k-steps): two independent mma chains
      float u2[2][4] = {};
      const T* x0 = h0 + (16 * um + g) * HLD + 2 * t;
      const T* x1 = x0 + 8 * HLD;
      const uint2* wp = reinterpret_cast<const uint2*>(w1p);
#pragma unroll 4
      for (int s = 0; s < C / 16; ++s) {
        const uint32_t af[4] = {*reinterpret_cast<const uint32_t*>(x0 + 16 * s),
                                *reinterpret_cast<const uint32_t*>(x1 + 16 * s),
                                *reinterpret_cast<const uint32_t*>(x0 + 16 * s + 8),
                                *reinterpret_cast<const uint32_t*>(x1 + 16 * s + 8)};
        const uint2 bv = __ldg(wp + (s * (FC / 8) + un) * 32 + lane);
        const uint32_t bf[2] = {bv.x, bv.y};
        lfs2::mma_bf16(u2[s & 1], af, bf);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) up[e] = u2[0][e] + u2[1][e];
    }
    // + b1, relu, rounded, into staging buffer i % 2 (every warp read buffer
    // (i - 2) % 2 before the last chunk's barrier)
    {
      const int f = i * FC + 8 * un + 2 * t;
      const float2 bb = *reinterpret_cast<const float2*>(a.b1 + f);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = lfs2::round_to<T>(fmaxf(up[e] + ((e & 1) ? bb.y : bb.x), 0.0f));
      if constexpr (kF32) {
        store_a_frag(reinterpret_cast<float4*>(stage) + ((un * (R / 16) + um) * 32 + lane) * 2, v);
      } else {
        T* st = reinterpret_cast<T*>(stage);
        const int r = 16 * um + g, c = 8 * un + 2 * t;
        *reinterpret_cast<uint32_t*>(st + r * kWideStageLd + c) = pack_bf16(v[0], v[1]);
        *reinterpret_cast<uint32_t*>(st + (r + 8) * kWideStageLd + c) = pack_bf16(v[2], v[3]);
      }
    }
    __syncthreads();  // the chunk's up staging is complete
    if constexpr (kF32) {
      // in groups of four n8 tiles, so that a group's partial sums and B
      // fragments stay few beside the accumulator
      constexpr int NG = 4;
#pragma unroll
      for (int gi = 0; gi < NT / NG; ++gi) {
        float acc[1][NG][4];
#pragma unroll
        for (int nt = 0; nt < NG; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[0][nt][e] = 0.0f;
        frags_x_piece<1, NG, FC / 8, R / 16, C / 8>(acc, reinterpret_cast<const float4*>(stage),
                                                    fm, reinterpret_cast<const float4*>(w2p),
                                                    fn * NT + gi * NG, lane);
#pragma unroll
        for (int nt = 0; nt < NG; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) ff[gi * NG + nt][e] += acc[0][nt][e];
      }
    } else {
      const T* st = reinterpret_cast<const T*>(stage) + (16 * fm + g) * kWideStageLd + 2 * t;
      const uint2* wp = reinterpret_cast<const uint2*>(w2p);
#pragma unroll
      for (int s = 0; s < FC / 16; ++s) {
        const uint32_t af[4] = {*reinterpret_cast<const uint32_t*>(st + 16 * s),
                                *reinterpret_cast<const uint32_t*>(st + 8 * kWideStageLd + 16 * s),
                                *reinterpret_cast<const uint32_t*>(st + 16 * s + 8),
                                *reinterpret_cast<const uint32_t*>(st + 8 * kWideStageLd + 16 * s + 8)};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint2 bv = __ldg(wp + (s * (C / 8) + fn * NT + nt) * 32 + lane);
          const uint32_t bf[2] = {bv.x, bv.y};
          lfs2::mma_bf16(ff[nt], af, bf);
        }
      }
    }
  }

  // the epilogue: ff + b2f into an f32 row buffer over the region (free once
  // every warp left the loop), then LN2 a row a warp
  __syncthreads();
  constexpr int RLD = C + 4;
  float* rows = reinterpret_cast<float*>(region);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = 8 * (fn * NT + nt) + 2 * t;
    const float2 bb = *reinterpret_cast<const float2*>(b2f + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * fm + g + 8 * h;
      *reinterpret_cast<float2*>(rows + r * RLD + c) =
          make_float2(ff[nt][2 * h] + bb.x, ff[nt][2 * h + 1] + bb.y);
    }
  }
  __syncthreads();
  for (int r = warp; r < R && t0 + r < T_len; r += ffn::kThreads / 32) {
    const size_t at = (static_cast<size_t>(b) * T_len + t0 + r) * C;
    const float2 st = stats[r + lpad];
    float v[NC], s = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      // res = t1 + ff, with t1 formed again from z and LN1's row statistics
      v[i] = rows[r * RLD + c] +
             lfs2::round_to<T>(ln_apply(lfs2::to_f(a.z[at + c]), st.x, st.y, g1[c], be1[c]));
      s += v[i];
      s2 += v[i] * v[i];
    }
    s = lfs2::warp_sum(s);
    s2 = lfs2::warp_sum(s2);
    const float mean = s / C;
    const float inv = rsqrtf(fmaxf(s2 / C - mean * mean, 0.0f) + a.eps);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      a.out[at + c] = lfs2::from_f<T>(ln_apply(v[i], mean, inv, g2[c], be2[c]));
    }
  }
}

template <typename T, int C>
cudaError_t wide_launch(const WideArgs<T>& a, int B, cudaStream_t stream) {
  const int smem = wide_smem<T, C>(a.k);
  if (a.k < 1 || smem > ffn::kMaxSmem || a.F % kWideFC != 0) return cudaErrorInvalidValue;
  auto kernel = ffn_wide_kernel<T, C>;
  cudaError_t err = lfs2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T_len + kWideRows - 1) / kWideRows, B);
  kernel<<<grid, ffn::kThreads, smem, stream>>>(a);
  return record_launch(grid, smem, kWideRows);
}

template <typename T>
cudaError_t wide_dispatch(int C, const WideArgs<T>& a, int B, cudaStream_t s) {
  switch (C) {
    case 384: return wide_launch<T, 384>(a, B, s);
    case 512: return wide_launch<T, 512>(a, B, s);
    case 640: return wide_launch<T, 640>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

static_assert(wide_smem<float, 640>(25) <= ffn::kMaxSmem, "f32 wide tile at k = 25");
static_assert(wide_smem<__nv_bfloat16, 640>(25) <= ffn::kMaxSmem, "bf16 wide tile at k = 25");

template <typename T>
cudaError_t wide_serve(const void* z, void* out, const float* wd, const float* b1,
                       const float* lnp, const void* img, int B, int T_len, int C, int F, int k,
                       float eps, cudaStream_t s) {
  WideArgs<T> a{static_cast<const T*>(z), static_cast<T*>(out), wd,
                static_cast<const uint8_t*>(img), b1, lnp, T_len, F, k, eps};
  return wide_dispatch<T>(C, a, B, s);
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

// Both routes read the weights from img: bf16 the swizzled image (ops/ffn.py
// _weight_image), f32 the split pieces (_f32_image); at C > 256 both take
// ffn_wide_kernel, bf16 reading _wide_image. rows: the rows of one item a
// block owns (ops/ffn.py ffn_plan): 128 in bf16, 32 or 64 in f32, 32 at
// C > 256
LFS2_EXPORT int lfs2_ffn_ln(const void* z, void* out, const float* wd, const float* b1,
                            const float* lnp, const void* img, int B, int T_len, int C, int F,
                            int k, int rows, float eps, int dtype, void* stream) {
  if (bad_shape(B, T_len, F, k)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C > 256) {  // ffn_wide_kernel, both dtypes
    if (rows != kWideRows) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        dtype == lfs2::kBF16
            ? wide_serve<__nv_bfloat16>(z, out, wd, b1, lnp, img, B, T_len, C, F, k, eps, s)
            : wide_serve<float>(z, out, wd, b1, lnp, img, B, T_len, C, F, k, eps, s));
  }
  if (dtype == lfs2::kBF16) {
    if (rows != ffn::kRows) return static_cast<int>(cudaErrorInvalidValue);
    FwdArgs a = bf16_args(z, wd, img, b1, lnp, nullptr, T_len, C, F, k, eps, 0u, 1.0f);
    a.out = static_cast<bf16*>(out);
    return static_cast<int>(bf16_dispatch<false>(a, B, s));
  }
  F32Args a = f32_args(z, wd, img, b1, lnp, nullptr, T_len, F, k, eps, 0u, 1.0f);
  a.out = static_cast<float*>(out);
  return static_cast<int>(f32_dispatch<false>(C, a, B, rows, s));
}

// seed: one int32 on the device; threshold and inv_keep from the rate
LFS2_EXPORT int lfs2_ffn_ln_train(const void* z, void* out, const float* wd, const float* b1,
                                  const float* lnp, const void* img, const int* seed, int B,
                                  int T_len, int C, int F, int k, int rows, float eps,
                                  unsigned threshold, float inv_keep, int dtype, void* stream) {
  if (bad_shape(B, T_len, F, k)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfs2::kBF16) {
    if (rows != ffn::kRows) return static_cast<int>(cudaErrorInvalidValue);
    FwdArgs a = bf16_args(z, wd, img, b1, lnp, seed, T_len, C, F, k, eps, threshold, inv_keep);
    a.out = static_cast<bf16*>(out);
    return static_cast<int>(bf16_dispatch<false>(a, B, s));
  }
  F32Args a = f32_args(z, wd, img, b1, lnp, seed, T_len, F, k, eps, threshold, inv_keep);
  a.out = static_cast<float*>(out);
  return static_cast<int>(f32_dispatch<false>(C, a, B, rows, s));
}

// The backward's first launch, the chain: the forward again with the LN2
// backward from dout; writes h0 and dff (the working dtype) and dres (f32),
// all (B, T, C), and adds dg2, dbe2 and db2f into dvec (6, C), a zeroed
// f32 buffer
LFS2_EXPORT int lfs2_ffn_ln_chain(const void* z, const void* dout, const float* wd,
                                  const void* img, const float* b1, const float* lnp,
                                  const int* seed, void* h0, float* dres, void* dff, float* dvec,
                                  int B, int T_len, int C, int F, int k, int rows, float eps,
                                  unsigned threshold, float inv_keep, int dtype, void* stream) {
  if (bad_shape(B, T_len, F, k)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfs2::kBF16) {
    if (rows != ffn::kRows) return static_cast<int>(cudaErrorInvalidValue);
    FwdArgs a = bf16_args(z, wd, img, b1, lnp, seed, T_len, C, F, k, eps, threshold, inv_keep);
    a.dout = static_cast<const bf16*>(dout);
    a.h0_out = static_cast<bf16*>(h0);
    a.dres_out = dres;
    a.dff_out = static_cast<bf16*>(dff);
    a.dvec = dvec;
    return static_cast<int>(bf16_dispatch<true>(a, B, s));
  }
  F32Args a = f32_args(z, wd, img, b1, lnp, seed, T_len, F, k, eps, threshold, inv_keep);
  a.dout = static_cast<const float*>(dout);
  a.h0_out = static_cast<float*>(h0);
  a.dres_out = dres;
  a.dff_out = static_cast<float*>(dff);
  a.dvec = dvec;
  return static_cast<int>(f32_dispatch<true>(C, a, B, rows, s));
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

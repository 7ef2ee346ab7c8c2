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
// Serving at C = 384, 512 and 640 (ffn_wide_kernel and ffn_wide_ln2_kernel,
// below). What bounds it: at (8, 512, 640) operations, 26.8 GFLOP (0.027 ms
// at bf16's 989 TFLOP/s, 0.163 ms as split TF32 at 165); at B = 1 the
// weights' bytes (6.55 MB in bf16, 0.002 ms). The first design read every
// weight fragment from L2 for every 32 rows, so its time was each block's
// weight stream. Here a block streams the weights once for its row tile
// (64 rows in bf16, 32 in f32), 32 F columns a chunk, as bulk copies of a
// pre-arranged image (ops/ffn.py _wide_image, _wide_f32_image) into
// shared memory, completed on mbarriers; the blocks of a cluster (2 or 4
// row tiles of one item) take each copy in one multicast, so L2 serves it
// once per 128 to 256 rows. On this card a bulk copy costs its issuing
// thread about 150 cycles whatever its size, and an SM's copies land at
// about 26 bytes a cycle when every SM reads L2 (70 alone), so the copies
// are few and large. To fill the card at small B T a launch splits F
// across blocks (grid z; ffn_plan picks the splits and the cluster from B
// and T): each block forms its split's ff partial sums over its rows (LN1
// and the depthwise taps a 64-channel box at a time into h0; per chunk up
// = relu(h0 @ W1 + b1), then ff += up @ W2f) and stores them to an f32
// scratch; ffn_wide_ln2_kernel adds the splits in split order (no atomics:
// a launch's bits repeat), b2f and the residual and takes LN2.
//   bf16: two warpgroups on wgmma; warpgroup 0 forms each up chunk (m64n32,
//   W1 K-major), both the down product of half the channels (m64n256 /
//   n128 / n64, W2f MN-major). W1 is double-buffered, one copy a chunk;
//   each warpgroup refills its own W2f boxes with one copy once its down
//   product is done. No producer warp: a ninth warp caps every thread at
//   168 registers, and a warpgroup's 64 x 320 f32 share of ff at C = 640
//   then spills.
//   f32: eight warps of split-TF32 mma.sync and a producer warp that
//   streams 16 KB slabs through a ring of six; the up chunk's K is split in
//   quarters across the warps (each split of h0 feeds four n8 tiles), the
//   quarters added in order in shared memory.
//
// Shapes the kernel takes: C in {32, 64, 128, 256} (serving and training)
// and {384, 512, 640} (serving), F a multiple of 128, any T >= 1; k >= 1
// while the t1 window fits shared memory (k <= 63 at C = 256 in bf16;
// rows + k - 1 <= 128 in f32; at C = 640 k <= 130 in bf16 and 100 in f32,
// more at C = 384 and 512).
#include "common.cuh"
#include "ffn_sm90.cuh"

namespace {

constexpr int kFChunk = 128;  // F must be a multiple of this

// the latest accepted launch, any route: grid x, y, z, shared-memory bytes
// a block, the rows of one item a block owns, the cluster size and, for a
// wide launch, the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters; 0 elsewhere); and the latest wide LN2
// pass's grid x, y, z, shared memory and rows
int g_last_launch[7];
int g_last_ln2[5];

cudaError_t record_launch(const dim3& grid, int smem, int rows, int cluster = 1, int resident = 0) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    g_last_launch[0] = grid.x;
    g_last_launch[1] = grid.y;
    g_last_launch[2] = grid.z;
    g_last_launch[3] = smem;
    g_last_launch[4] = rows;
    g_last_launch[5] = cluster;
    g_last_launch[6] = resident;
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
// ffn_wide_kernel<T, C> forms one split's ff partial sums, ffn_wide_ln2_kernel<T, C>
// adds the splits in order and takes the residual and LN2 (the design is in
// the note at the top). Geometry (ops/ffn.py ffn_plan and _wide_smem mirror
// it):
//   R        rows of one item a block owns: 64 in bf16 (one wgmma M), 32 in f32
//   kWideFC  F columns a chunk: a W1 part (K = C, N = 32) and a W2f part
//            (K = 32, N = C), each C / 64 tiles of the weight image
//   TILE     bf16: 4 KB, a box of 32 rows (f) by 64 channels in 128-byte rows
//            and the 128-byte swizzle (W1 K-major, W2f MN-major; ops/ffn.py
//            _wide_image); f32: 16 KB, split TF32 fragments of 64 k indices
//            by 32 columns (W1) or 32 k indices by 64 columns (W2f)
//            (_wide_f32_image)
//   NS       f32: ring slots (kWideF32Slots); bf16: the four buffers and
//            their barriers (W1 buffers A and B, each warpgroup's W2f boxes)
//   THREADS  bf16: two warpgroups (256 threads; a ninth warp would cap every
//            thread at 168 registers, and a warpgroup's 64 x 320 f32 share
//            of ff at C = 640 then spills), each refilling the buffers it
//            reads; f32: eight warps and a producer warp (288), which keeps
//            the copies' issue (about 150 cycles each) and, in a cluster,
//            the wait for the other blocks off the consumers
// Shared memory from a 1024-byte aligned base (WideGeo lists the order):
// the weight buffers, h0, two up stagings, one region that is the t1
// window of a 64-channel box (f32, R + k - 1 rows) in the prologue and then
// W1 buffer B (bf16) or the up product's K-quarter partials (f32), each
// window row's LN1 statistics, and the full, cluster-free and (f32) empty
// mbarriers of every buffer.
constexpr int kWideFC = 32;
constexpr int kWideF32Slots = 6;

template <typename T, int C> struct WideGeo {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int R = kF32 ? 32 : 64;
  static constexpr int TILE = kF32 ? 16384 : 4096;
  static constexpr int NB = C / 64;           // tiles of a chunk's W1 part, and of its W2f part
  static constexpr int TPC = 2 * NB;          // tiles a chunk
  static constexpr int NS = kF32 ? kWideF32Slots : 4;  // f32 ring slots; bf16 buffers
  static constexpr int H0 = R * C * static_cast<int>(sizeof(T));
  static constexpr int STAGE = kF32 ? R * kWideFC * 8 : R * 128;
  // f32: the ring, h0, the stagings, the region (the window, then the
  // K-quarter partials); bf16: h0, the stagings, W1 buffer A, the two
  // warpgroups' W2f boxes, W1 buffer B (the window during the prologue,
  // the region running past it where the window is larger)
  static constexpr int H0_AT = kF32 ? NS * TILE : 0;
  static constexpr int STAGE_AT = H0_AT + H0;
  static constexpr int W1A_AT = STAGE_AT + 2 * STAGE;
  static constexpr int W2_AT = W1A_AT + NB * TILE;
  static constexpr int WIN_AT = kF32 ? STAGE_AT + 2 * STAGE : W2_AT + NB * TILE;
  static constexpr int PARTS = kF32 ? 4 * R * kWideFC * 4 : NB * TILE;
  static constexpr int THREADS = kF32 ? 288 : 256;
  __host__ __device__ static constexpr int region(int k) {
    return (R + k - 1) * 64 * 4 > PARTS ? (R + k - 1) * 64 * 4 : PARTS;
  }
  __host__ __device__ static constexpr int stats_at(int k) { return WIN_AT + region(k); }
  __host__ __device__ static constexpr int bars_at(int k) { return stats_at(k) + (R + k - 1) * 8; }
  __host__ __device__ static constexpr int smem(int k) { return 1024 + bars_at(k) + 3 * NS * 8; }
};

template <typename T> struct WideArgs {
  const T* z;
  float* part;          // (S, B, T, C) f32: each split's ff partial sums
  const float* wd;
  const uint8_t* img;   // the weight image: chunk after chunk of TPC tiles
  const float* b1;
  const float* lnp;
  int T_len, F, k, per;  // per: chunks a split
  float eps;
};

__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_nctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
// every thread of every block of the cluster (a block barrier with m = 1)
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// an arrival on the mbarrier at the same offset in block `rank` of the
// cluster (the default release at CTA scope: what it orders is the
// block's own reads of the buffer, done before; a release at cluster scope
// from a thread that issues bulk copies cost it a copy's latency each)
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}
// contiguous bytes into the same offset of every block of `mask`, completed
// on each block's mbarrier at the same offset
__device__ __forceinline__ void bulk_load_multicast(uint32_t dst, const void* src, unsigned bytes,
                                                    uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// `bytes` of the image into the buffer at dst, its `use`-th fill, once the
// block is done with the buffer's previous contents: the block arms the
// buffer's full barrier; in a cluster the other blocks tell rank 0 on its
// cluster-free barrier, and rank 0 issues the copy to every block in one
// multicast once all of them did. (Issuing a bulk copy costs its thread
// about 150 cycles, whatever its size, and one SM's copies land at up to
// about 70 bytes a cycle alone, about 26 with every SM reading L2:
// scripts/probe_bulk_copy.cu. So few, large copies.)
__device__ __forceinline__ void wide_issue(const uint8_t* src, int bytes, uint32_t dst,
                                           uint32_t full, uint32_t clfree, unsigned use,
                                           unsigned m, unsigned rank) {
  ffn::mbar_expect_tx(full, bytes);
  if (m == 1) {
    ffn::bulk_load(dst, src, bytes, full);
  } else if (rank != 0) {
    mbar_arrive_cluster(clfree, 0);
  } else {
    mbar_arrive(clfree);
    ffn::mbar_wait(clfree, use & 1);
    bulk_load_multicast(dst, src, bytes, full, static_cast<uint16_t>((1u << m) - 1));
  }
}

// 8 consecutive values of z (16 bytes in bf16, 32 in f32) as raw words,
// and as floats
template <typename T> struct Piece {
  uint4 w[sizeof(T) / 2];
};
template <typename T> __device__ __forceinline__ Piece<T> load_piece(const T* p) {
  Piece<T> x;
#pragma unroll
  for (int h = 0; h < static_cast<int>(sizeof(T)) / 2; ++h) x.w[h] = reinterpret_cast<const uint4*>(p)[h];
  return x;
}
template <typename T> __device__ __forceinline__ void unpack_piece(const Piece<T>& x, float (&v)[8]) {
  if constexpr (sizeof(T) == 4) {
    const float* f = reinterpret_cast<const float*>(x.w);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = f[e];
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(x.w);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  }
}

// The prologue, on the 256 consumer threads: LN1's statistics of the
// window rows (item rows t0 - lpad ..), then per 64-channel box the t1
// window (rounded to T, zero outside [0, T)) and the depthwise taps into h0
// (rounded to T): bf16 into the swizzled K-major tile, f32 into rows of C
// with swz32 columns. Its reads of z are latency-bound, so they are issued
// together: a warp's statistics take RG rows at once, 16-byte pieces a
// lane, and each box's z pieces are loaded into registers while the
// previous box's taps run (kWidePieces a thread at most: W 8 <= 2048).
constexpr int kWidePieces = 8;

template <typename T, int C, int R>
__device__ __forceinline__ void wide_prologue(const WideArgs<T>& a, uint8_t* smem, int h0_at,
                                              float* win, float2* stats, int t0) {
  using namespace ffn;
  constexpr int NR = R / 8;                           // depthwise rows a thread
  constexpr int NP = C / 8, NI = (NP + 31) / 32;      // a row's pieces; a lane's
  constexpr int RG = sizeof(T) == 4 ? 2 : 4;          // rows a warp's statistics take at once
  const int k = a.k, T_len = a.T_len, lpad = (k - 1) / 2, W = R + k - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* zb = a.z + static_cast<size_t>(blockIdx.y) * T_len * C;
  const float* g1 = a.lnp;
  const float* be1 = a.lnp + C;
  const float* bd = a.lnp + 4 * C;
  auto inside = [&](int r) { return t0 - lpad + r >= 0 && t0 - lpad + r < T_len; };
  for (int r0 = warp; r0 < W; r0 += 8 * RG) {
    Piece<T> x[RG][NI];
#pragma unroll
    for (int q = 0; q < RG; ++q)
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int r = r0 + 8 * q, p = lane + 32 * i;
        if (r < W && p < NP && inside(r)) x[q][i] = load_piece(zb + static_cast<size_t>(t0 - lpad + r) * C + 8 * p);
        else x[q][i] = Piece<T>{};
      }
#pragma unroll
    for (int q = 0; q < RG; ++q) {
      float s = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        float v[8];
        unpack_piece(x[q][i], v);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s += v[e];
          s2 += v[e] * v[e];
        }
      }
      s = lfs2::warp_sum(s);
      s2 = lfs2::warp_sum(s2);
      const float mean = s / C;
      if (lane == 0 && r0 + 8 * q < W)
        stats[r0 + 8 * q] = make_float2(mean, rsqrtf(fmaxf(s2 / C - mean * mean, 0.0f) + a.eps));
    }
  }
  // a thread's pieces of a box: window row u / 8, channels 8 (u % 8) .. of
  // the box, u = threadIdx.x + 256 q
  Piece<T> zp[kWidePieces];
  auto load_box = [&](int cb) {
#pragma unroll
    for (int q = 0; q < kWidePieces; ++q) {
      const int u = threadIdx.x + 256 * q, r = u >> 3;
      if (r < W && inside(r)) zp[q] = load_piece(zb + static_cast<size_t>(t0 - lpad + r) * C + 64 * cb + 8 * (u & 7));
      else zp[q] = Piece<T>{};
    }
  };
  load_box(0);
  named_sync(2);  // the statistics are complete
  const int cp = 2 * lane, r0 = NR * warp;
  for (int cb = 0; cb < C / 64; ++cb) {
#pragma unroll
    for (int q = 0; q < kWidePieces; ++q) {
      const int u = threadIdx.x + 256 * q, r = u >> 3, c = 8 * (u & 7);
      if (r >= W) break;
      float v[8], o[8], gv[8], bv[8];
      unpack_piece(zp[q], v);
      lfs2::load_vec<8>(g1 + 64 * cb + c, gv);
      lfs2::load_vec<8>(be1 + 64 * cb + c, bv);
      const float2 st = stats[r];
      const bool in = inside(r);
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = in ? lfs2::round_to<T>(ln_apply(v[e], st.x, st.y, gv[e], bv[e])) : 0.0f;
      *reinterpret_cast<float4*>(win + r * 64 + c) = make_float4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<float4*>(win + r * 64 + c + 4) = make_float4(o[4], o[5], o[6], o[7]);
    }
    named_sync(2);
    if (cb + 1 < C / 64) load_box(cb + 1);  // in flight while the taps run
    // h0[r][c] = sum_j t1[r + j][c] wd[j][c] + bd[c]: NR rows by a channel
    // pair a thread, taps 8 at a time over a register window
    const int c = 64 * cb + cp;
    float2 acc[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) acc[i] = make_float2(0.0f, 0.0f);
    for (int j0 = 0; j0 < k; j0 += 8) {
      float2 w[8], x[NR + 7];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        w[jj] = j0 + jj < k ? __ldg(reinterpret_cast<const float2*>(a.wd + (j0 + jj) * C + c))
                            : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int q = 0; q < NR + 7; ++q) {
        const int rr = r0 + j0 + q;
        x[q] = rr < W ? *reinterpret_cast<const float2*>(win + rr * 64 + cp) : make_float2(0.0f, 0.0f);
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          acc[i].x += x[i + jj].x * w[jj].x;
          acc[i].y += x[i + jj].y * w[jj].y;
        }
    }
    const float2 bias = *reinterpret_cast<const float2*>(bd + c);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int r = r0 + i;
      const float hx = acc[i].x + bias.x, hy = acc[i].y + bias.y;
      if constexpr (sizeof(T) == 4)
        *reinterpret_cast<float2*>(smem + h0_at + (r * C + swz32(r, c)) * 4) = make_float2(hx, hy);
      else
        *reinterpret_cast<uint32_t*>(smem + h0_at + swz(r, c, R)) = pack_bf16(hx, hy);
    }
    if constexpr (sizeof(T) != 4) fence_proxy_async();  // h0 is read by wgmma
    named_sync(2);  // the window is free again; after the last box h0 is complete
  }
}

// a wgmma accumulator (rows r and r + 8; columns c + 8 q, + 1) into rows of
// C f32, rows below `rows` only
template <int C, int N>
__device__ __forceinline__ void store_acc(float* dst, const float (&acc)[N], int r, int c, int rows) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r + 8 * h < rows)
        *reinterpret_cast<float2*>(dst + static_cast<size_t>(r + 8 * h) * C + c + 8 * q) =
            make_float2(acc[4 * q + 2 * h], acc[4 * q + 2 * h + 1]);
}

template <typename T, int C>
__global__ void __launch_bounds__(WideGeo<T, C>::THREADS, 1)
ffn_wide_kernel(const __grid_constant__ WideArgs<T> a) {
  using namespace ffn;
  using G = WideGeo<T, C>;
  constexpr int R = G::R, NS = G::NS, TPC = G::TPC, TILE = G::TILE;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const int k = a.k;
  const uint32_t bars = base + G::bars_at(k);  // full[NS], clfree[NS], empty[NS]
  auto full = [bars](int s) { return bars + 8 * s; };
  auto clfree = [bars](int s) { return bars + 8 * (NS + s); };
  auto empty = [bars](int s) { return bars + 8 * (2 * NS + s); };
  const int b = blockIdx.y, t0 = blockIdx.x * R, split = blockIdx.z;
  const int nch = a.F / kWideFC, c0 = split * a.per, n = min(nch - c0, a.per);
  const unsigned m = cluster_nctarank(), rank = cluster_ctarank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint8_t* src = a.img + static_cast<size_t>(c0) * TPC * TILE;
  constexpr int NB = G::NB;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(clfree(s), m);
      mbar_init(empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync_all();

  // f32: the producer warp streams the split's tiles through the ring, tile
  // j into slot j % NS once the eight warps released tile j - NS
  if constexpr (G::kF32) {
    if (warp == 8) {
      if (lane == 0)
        for (int j = 0; j < n * TPC; ++j) {
          if (j >= NS) mbar_wait(empty(j % NS), (j / NS - 1) & 1);
          wide_issue(src + static_cast<size_t>(j) * TILE, TILE, base + (j % NS) * TILE,
                     full(j % NS), clfree(j % NS), j / NS, m, rank);
        }
      __syncwarp();
      cluster_sync_all();
      return;
    }
  }
  const int g = lane >> 2, t = lane & 3;
  // bf16: a warpgroup's share of the channels; warpgroup 0 also forms the
  // up chunks. A buffer is read by one warpgroup, which refills it: W1
  // double-buffered (chunk c in buffer c % 2, barrier group c % 2), each
  // warpgroup's W2f boxes (group 2 + warpgroup) single, each part one copy.
  constexpr int NH = C / 2, NA = NH >= 256 ? 256 : 128, NX = NH - NA, BPW = NH / 64;
  constexpr int CHUNK = TPC * TILE;
  const int wg = threadIdx.x >> 7, wt = threadIdx.x & 127;
  auto issue_w1 = [&](int c) {
    wide_issue(src + static_cast<size_t>(c) * CHUNK, NB * TILE,
               base + ((c & 1) ? G::WIN_AT : G::W1A_AT), full(c & 1), clfree(c & 1), c >> 1, m,
               rank);
  };
  auto issue_w2 = [&](int c) {
    wide_issue(src + static_cast<size_t>(c) * CHUNK + (NB + wg * BPW) * TILE, BPW * TILE,
               base + G::W2_AT + wg * BPW * TILE, full(2 + wg), clfree(2 + wg), c, m, rank);
  };
  if constexpr (!G::kF32) {
    if (wt == 0) {
      if (wg == 0) issue_w1(0);
      issue_w2(0);
    }
    __syncwarp();
  }
  FFN_CLOCK(tp);
  wide_prologue<T, C, R>(a, smem, G::H0_AT, reinterpret_cast<float*>(smem + G::WIN_AT),
                         reinterpret_cast<float2*>(smem + G::stats_at(k)), t0);
  FFN_PHASE(0, tp);  // prologue
  float* dst = a.part + ((static_cast<size_t>(split) * gridDim.y + b) * a.T_len + t0) * C;
  const int rows_in = a.T_len - t0;  // rows of the tile inside the item

  if constexpr (!G::kF32) {
    if (wg == 0 && wt == 0 && n > 1) issue_w1(1);  // into W1 buffer B, the window until now
    __syncwarp();
    const int rl = 16 * (wt >> 5) + g;
    float ffa[NA / 2], ffx[NX > 0 ? NX / 2 : 1];
#pragma unroll
    for (int i = 0; i < NA / 2; ++i) ffa[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < (NX > 0 ? NX / 2 : 1); ++i) ffx[i] = 0.0f;
    const uint32_t h0d = desc(base + G::H0_AT);
    for (int i = 0; i < n; ++i) {
      const int stage_at = G::STAGE_AT + (i & 1) * G::STAGE;
      if (wg == 0) {
        float up[16];
        float2 bb[4];  // b1 of the thread's columns, loaded while the product runs
#pragma unroll
        for (int q = 0; q < 4; ++q)
          bb[q] = *reinterpret_cast<const float2*>(a.b1 + (c0 + i) * kWideFC + 8 * q + 2 * t);
        mbar_wait(full(i & 1), (i >> 1) & 1);
        FFN_PHASE(1, tp);  // waiting for W1
        wgmma_fence();
        {
          const uint32_t w1d = opaque(desc(base + ((i & 1) ? G::WIN_AT : G::W1A_AT)));
          const uint32_t ad = opaque(h0d);
#pragma unroll
          for (int kk = 0; kk < 4 * NB; ++kk)
            SsOp<32>::run<0, 0>(up, kmajor(ad, R, 0, kk), w1d + ((kk >> 2) * TILE + (kk & 3) * 32) / 16,
                                kk != 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        hold(up);
        FFN_PHASE(2, tp);  // up product
        // + b1, relu, rounded: the down product's A, K-major
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = lfs2::round_to<T>(fmaxf(up[4 * q + e] + ((e & 1) ? bb[q].y : bb[q].x), 0.0f));
          *reinterpret_cast<uint32_t*>(smem + stage_at + swz(rl, 8 * q + 2 * t, R)) = pack_bf16(v[0], v[1]);
          *reinterpret_cast<uint32_t*>(smem + stage_at + swz(rl + 8, 8 * q + 2 * t, R)) = pack_bf16(v[2], v[3]);
        }
        fence_proxy_async();
        FFN_PHASE(3, tp);  // up epilogue
      }
      named_sync(1);  // the chunk's up staging is complete
      FFN_PHASE(4, tp);  // waiting for the staging
      mbar_wait(full(2 + wg), i & 1);
      FFN_PHASE(5, tp);  // waiting for W2f
      wgmma_fence();
      {
        const uint32_t sd = opaque(desc(base + stage_at));
        const uint32_t wa = opaque(desc(base + G::W2_AT + wg * BPW * TILE, TILE));
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) SsOp<NA>::template run<0, 1>(ffa, kmajor(sd, R, 0, kk), mnmajor(wa, kk), 1);
        if constexpr (NX > 0) {
          const uint32_t wx = opaque(desc(base + G::W2_AT + (wg * BPW + NA / 64) * TILE, TILE));
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) SsOp<64>::run<0, 1>(ffx, kmajor(sd, R, 0, kk), mnmajor(wx, kk), 1);
        }
      }
      wgmma_commit();
      // W1 buffer i % 2 is free (up(i) is done): chunk i + 2, while the
      // down product runs
      if (wg == 0 && wt == 0 && i + 2 < n) issue_w1(i + 2);
      __syncwarp();
      wgmma_wait<0>();
      hold(ffa);
      hold(ffx);
      FFN_PHASE(6, tp);  // down product
      if (wt == 0 && i + 1 < n) issue_w2(i + 1);  // the warpgroup's boxes of the next chunk
      __syncwarp();
    }
    // the split's partial sums, rows inside the item only
    store_acc<C>(dst, ffa, rl, wg * NH + 2 * t, rows_in);
    if constexpr (NX > 0) store_acc<C>(dst, ffx, rl, wg * NH + NA + 2 * t, rows_in);
  } else {
    // eight warps of split-TF32 mma.sync: per chunk
    //   up (32 x 32) = h0 @ W1 part   warps 2 x 4: 16 rows by the chunk's 32
    //                                 columns over every fourth W1 slab (a
    //                                 quarter of K), the quarters added in
    //                                 order in shared memory
    //   + b1, relu, split into the down product's A fragments (staging)
    //   ff (32 x C) += up @ W2f part  warps 2 x 4 of 16 rows by the n8
    //                                 tiles 8 nb + fn, + 4 of each box nb
    // every product sums at most 64 k indices from zero and adds them in
    // f32; every warp releases every slot it passed
    const int um = warp & 1, kq = warp >> 1;
    auto release = [&](int j) {  // the warp is done with tile j
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(j % NS));
    };
    const float* h0f = reinterpret_cast<const float*>(smem + G::H0_AT);
    float4* parts = reinterpret_cast<float4*>(smem + G::WIN_AT);  // [kq][um][n8 tile][lane]
    const int ra = 16 * um + g;
    float ff[C / 32][4];
#pragma unroll
    for (int q = 0; q < C / 32; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) ff[q][e] = 0.0f;
    for (int i = 0, j = 0; i < n; ++i, j += TPC) {
      float4* stage = reinterpret_cast<float4*>(smem + G::STAGE_AT + (i & 1) * G::STAGE);
      float4* mine = parts + (kq * 2 + um) * 4 * 32 + lane;  // this warp's partials
#pragma unroll 1
      for (int kb = 0; kb < NB; ++kb) {
        const int s = (j + kb) % NS;
        FFN_PHASE(2, tp);  // up product
        mbar_wait(full(s), ((j + kb) / NS) & 1);
        FFN_PHASE(1, tp);  // waiting for W1
        if ((kb & 3) == kq) {
          const float4* slab = reinterpret_cast<const float4*>(smem + s * TILE);
          float tc[4][4] = {};
#pragma unroll
          for (int st = 0; st < 8; ++st) {
            const int col = 64 * kb + 8 * st + 2 * t;
            const float2 a0 = *reinterpret_cast<const float2*>(h0f + ra * C + swz32(ra, col));
            const float2 a1 = *reinterpret_cast<const float2*>(h0f + (ra + 8) * C + swz32(ra + 8, col));
            uint32_t ah[4], al[4];
            lfs2::split_a(a0.x, a1.x, a0.y, a1.y, ah, al);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              uint32_t bh[2], bl[2];
              lfs2::frag_b(slab[(st * 4 + nt) * 32 + lane], bh, bl);
              lfs2::mma3(tc[nt], ah, al, bh, bl);
            }
          }
          // the slab's sums into the warp's partials in shared memory (kept
          // in registers beside ff they would spill at C = 640)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            float4 p = make_float4(tc[nt][0], tc[nt][1], tc[nt][2], tc[nt][3]);
            if (kb != kq) {
              const float4 q = mine[nt * 32];
              p = make_float4(q.x + p.x, q.y + p.y, q.z + p.z, q.w + p.w);
            }
            mine[nt * 32] = p;
          }
        }
        release(j + kb);
      }
      named_sync(1);  // the chunk's K-quarter partials are complete
      {
        // warp w: n8 tile w / 2 of m16 tile w % 2, the quarters added in
        // order, + b1, relu, into staging i % 2 as the down product's A
        const int nt = warp >> 1;
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 p = parts[((q * 2 + um) * 4 + nt) * 32 + lane];
          v[0] += p.x, v[1] += p.y, v[2] += p.z, v[3] += p.w;
        }
        const float2 bb = *reinterpret_cast<const float2*>(a.b1 + (c0 + i) * kWideFC + 8 * nt + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = fmaxf(v[e] + ((e & 1) ? bb.y : bb.x), 0.0f);
        store_a_frag(stage + ((nt * (R / 16) + um) * 32 + lane) * 2, v);
      }
      FFN_PHASE(3, tp);  // up epilogue
      named_sync(1);  // the chunk's up staging is complete
      FFN_PHASE(4, tp);  // waiting for the staging
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        const float4* p = stage + ((st * (R / 16) + um) * 32 + lane) * 2;
        const float4 h = p[0], l = p[1];
        ah[st][0] = __float_as_uint(h.x), ah[st][1] = __float_as_uint(h.y);
        ah[st][2] = __float_as_uint(h.z), ah[st][3] = __float_as_uint(h.w);
        al[st][0] = __float_as_uint(l.x), al[st][1] = __float_as_uint(l.y);
        al[st][2] = __float_as_uint(l.z), al[st][3] = __float_as_uint(l.w);
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int s = (j + NB + nb) % NS;
        FFN_PHASE(6, tp);  // down product
        mbar_wait(full(s), ((j + NB + nb) / NS) & 1);
        FFN_PHASE(5, tp);  // waiting for W2f
        const float4* slab = reinterpret_cast<const float4*>(smem + s * TILE);
        float tc[2][4] = {};
#pragma unroll
        for (int st = 0; st < 4; ++st)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t bh[2], bl[2];
            lfs2::frag_b(slab[(st * 8 + kq + 4 * h) * 32 + lane], bh, bl);
            lfs2::mma3(tc[h], ah[st], al[st], bh, bl);
          }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) ff[2 * nb + h][e] += tc[h][e];
        release(j + NB + nb);
      }
    }
#pragma unroll
    for (int q = 0; q < C / 32; ++q) {
      const int c = 8 * (8 * (q >> 1) + kq + 4 * (q & 1)) + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ra + 8 * h;
        if (r < rows_in)
          *reinterpret_cast<float2*>(dst + static_cast<size_t>(r) * C + c) = make_float2(ff[q][2 * h], ff[q][2 * h + 1]);
      }
    }
  }
  FFN_PHASE(7, tp);  // partial sums stored
  FFN_FLUSH();
  __syncwarp();
  cluster_sync_all();  // no block leaves while a multicast or an arrival may still reach it
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(ffn::pack_bf16(v[0], v[1]), ffn::pack_bf16(v[2], v[3]));
}

// The warps an LN2 row takes: up to 8, so that a row's S split partials
// are read by as many warps at once (S / WR each, in split order); the
// block's 8 warps take 8 / WR rows (ops/ffn.py _wide_ln2_warps)
__host__ __device__ constexpr int wide_ln2_warps(int splits) {
  return splits >= 8 ? 8 : splits >= 4 ? 4 : splits >= 2 ? 2 : 1;
}

// ffn_wide_ln2_kernel<T, C>: WR warps a row, channels 4 (lane + 32 i) .. +
// 3 a lane; warp p of a row adds splits p, p + WR, .. in order, and the
// row's first warp adds the WR sums in warp order (shared memory), + b2f;
// the residual's t1 formed again from z (LN1's statistics taken again);
// LN2 into out. The order is fixed, so a launch's bits repeat.
template <typename T, int C>
__global__ void __launch_bounds__(256, 1)
ffn_wide_ln2_kernel(const T* __restrict__ z, T* __restrict__ out, const float* __restrict__ part,
                    const float* __restrict__ lnp, int rows, int splits, float eps) {
  constexpr int NV = C / 128;
  __shared__ float4 sums[8][NV * 32];
  const int wr = wide_ln2_warps(splits), warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (8 / wr) + warp / wr, p = warp % wr;
  float v[NV][4] = {};
  if (row < rows) {
#pragma unroll 4
    for (int sp = p; sp < splits; sp += wr)
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float q[4];
        load4(part + (static_cast<size_t>(sp) * rows + row) * C + 4 * (lane + 32 * i), q);
#pragma unroll
        for (int e = 0; e < 4; ++e) v[i][e] += q[e];
      }
  }
  if (wr > 1) {
    if (p > 0)
#pragma unroll
      for (int i = 0; i < NV; ++i) sums[warp][lane + 32 * i] = make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
    __syncthreads();
    if (p > 0) return;
    for (int w = 1; w < wr; ++w)
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 q = sums[warp + w][lane + 32 * i];
        v[i][0] += q.x, v[i][1] += q.y, v[i][2] += q.z, v[i][3] += q.w;
      }
  }
  if (row >= rows) return;
  const float* g1 = lnp;
  const float* be1 = lnp + C;
  const float* g2 = lnp + 2 * C;
  const float* be2 = lnp + 3 * C;
  const float* b2f = lnp + 5 * C;
  float zv[NV][4], s = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    load4(z + static_cast<size_t>(row) * C + 4 * (lane + 32 * i), zv[i]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s += zv[i][e];
      s2 += zv[i][e] * zv[i][e];
    }
  }
  s = lfs2::warp_sum(s);
  s2 = lfs2::warp_sum(s2);
  const float mean1 = s / C, inv1 = rsqrtf(fmaxf(s2 / C - mean1 * mean1, 0.0f) + eps);
  s = s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * (lane + 32 * i) + e;
      v[i][e] = (v[i][e] + b2f[c]) +
                lfs2::round_to<T>(ffn::ln_apply(zv[i][e], mean1, inv1, g1[c], be1[c]));
      s += v[i][e];
      s2 += v[i][e] * v[i][e];
    }
  s = lfs2::warp_sum(s);
  s2 = lfs2::warp_sum(s2);
  const float mean2 = s / C, inv2 = rsqrtf(fmaxf(s2 / C - mean2 * mean2, 0.0f) + eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * (lane + 32 * i) + e;
      o[e] = ffn::ln_apply(v[i][e], mean2, inv2, g2[c], be2[c]);
    }
    store4(out + static_cast<size_t>(row) * C + 4 * (lane + 32 * i), o);
  }
}

// the resident clusters of a launch configuration
// (cudaOccupancyMaxActiveClusters), asked once per kernel, shared memory and
// cluster size; -1 where the query fails
struct ClusterOccupancy {
  const void* fn;
  int smem, cluster, n;
};
ClusterOccupancy g_occupancy[64];
int g_n_occupancy = 0;

int max_active_clusters(const void* fn, const cudaLaunchConfig_t& cfg, int cluster) {
  const int smem = static_cast<int>(cfg.dynamicSmemBytes);
  for (int i = 0; i < g_n_occupancy; ++i)
    if (g_occupancy[i].fn == fn && g_occupancy[i].smem == smem && g_occupancy[i].cluster == cluster)
      return g_occupancy[i].n;
  int n = -1;
  if (cudaOccupancyMaxActiveClusters(&n, fn, &cfg) != cudaSuccess) {
    n = -1;
    cudaGetLastError();  // the query's error is not the launch's
  }
  if (g_n_occupancy < 64) g_occupancy[g_n_occupancy++] = {fn, smem, cluster, n};
  return n;
}

template <typename T, int C>
cudaError_t wide_launch(WideArgs<T> a, T* out, int B, int splits, int cluster, cudaStream_t stream) {
  using G = WideGeo<T, C>;
  const int smem = G::smem(a.k), nch = a.F / kWideFC;
  if (a.k < 1 || smem > ffn::kMaxSmem || (G::R + a.k - 1) * 8 > 256 * kWidePieces ||
      a.F % kWideFC != 0 || splits < 1 || splits > nch ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8))
    return cudaErrorInvalidValue;
  a.per = (nch + splits - 1) / splits;
  if ((splits - 1) * a.per >= nch) return cudaErrorInvalidValue;  // a split without chunks
  auto kernel = ffn_wide_kernel<T, C>;
  cudaError_t err = lfs2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (a.T_len + G::R - 1) / G::R;
  const dim3 grid((tiles + cluster - 1) / cluster * cluster, B, splits);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(G::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int resident = max_active_clusters(reinterpret_cast<const void*>(kernel), cfg, cluster);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  err = record_launch(grid, smem, G::R, cluster, resident);
  if (err != cudaSuccess) return err;
  const int rows = B * a.T_len;
  const int ln2_rows = 8 / wide_ln2_warps(splits);
  const dim3 grid2((rows + ln2_rows - 1) / ln2_rows);
  ffn_wide_ln2_kernel<T, C><<<grid2, 256, 0, stream>>>(a.z, out, a.part, a.lnp, rows,
                                                                      splits, a.eps);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    g_last_ln2[0] = grid2.x;
    g_last_ln2[1] = grid2.y;
    g_last_ln2[2] = grid2.z;
    g_last_ln2[3] = 0;
    g_last_ln2[4] = ln2_rows;
  }
  return err;
}

template <typename T>
cudaError_t wide_serve(const void* z, void* out, float* part, const float* wd, const float* b1,
                       const float* lnp, const void* img, int B, int T_len, int C, int F, int k,
                       int splits, int cluster, float eps, cudaStream_t s) {
  WideArgs<T> a{static_cast<const T*>(z), part, wd, static_cast<const uint8_t*>(img), b1, lnp,
                T_len, F, k, 0, eps};
  T* o = static_cast<T*>(out);
  switch (C) {
    case 384: return wide_launch<T, 384>(a, o, B, splits, cluster, s);
    case 512: return wide_launch<T, 512>(a, o, B, splits, cluster, s);
    case 640: return wide_launch<T, 640>(a, o, B, splits, cluster, s);
    default: return cudaErrorInvalidValue;
  }
}

static_assert(WideGeo<float, 640>::smem(27) <= ffn::kMaxSmem, "f32 wide tile at C = 640, k = 27");
static_assert(WideGeo<__nv_bfloat16, 640>::smem(43) <= ffn::kMaxSmem, "bf16 wide tile at C = 640, k = 43");
static_assert(WideGeo<__nv_bfloat16, 640>::STAGE == 64 * 128 && WideGeo<float, 640>::STAGE == 32 * 32 * 8,
              "an up staging");

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
// _weight_image), f32 the split pieces (_f32_image). rows: the rows of one
// item a block owns (ops/ffn.py ffn_plan): 128 in bf16, 32 or 64 in f32
LFS2_EXPORT int lfs2_ffn_ln(const void* z, void* out, const float* wd, const float* b1,
                            const float* lnp, const void* img, int B, int T_len, int C, int F,
                            int k, int rows, float eps, int dtype, void* stream) {
  if (bad_shape(B, T_len, F, k)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
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

// Serving at C = 384, 512 and 640, both dtypes: ffn_wide_kernel into part
// (splits, B, T, C) f32 scratch, then ffn_wide_ln2_kernel into out. img is
// ops/ffn.py _wide_image (bf16) or _wide_f32_image (f32); splits and
// cluster come from ffn_plan.
LFS2_EXPORT int lfs2_ffn_ln_wide(const void* z, void* out, float* part, const float* wd,
                                 const float* b1, const float* lnp, const void* img, int B,
                                 int T_len, int C, int F, int k, int splits, int cluster,
                                 float eps, int dtype, void* stream) {
  if (bad_shape(B, T_len, F, k)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == lfs2::kBF16
          ? wide_serve<__nv_bfloat16>(z, out, part, wd, b1, lnp, img, B, T_len, C, F, k, splits,
                                      cluster, eps, s)
          : wide_serve<float>(z, out, part, wd, b1, lnp, img, B, T_len, C, F, k, splits, cluster,
                              eps, s));
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

// copies into out[0..6] the latest accepted launch (g_last_launch) and into
// out[7..11] the latest wide LN2 pass (g_last_ln2); zeros before the first
LFS2_EXPORT int lfs2_ffn_ln_last_launch(int* out) {
  for (int i = 0; i < 7; ++i) out[i] = g_last_launch[i];
  for (int i = 0; i < 5; ++i) out[7 + i] = g_last_ln2[i];
  return 0;
}

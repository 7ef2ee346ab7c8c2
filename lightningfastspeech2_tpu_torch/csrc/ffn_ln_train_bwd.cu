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
// f32 route: the same three launches, the products as split TF32 on the
// tensor cores (mma.sync m16n8k8, three TF32 products a product, f32's
// digits): (a) ffn_ln.cu's ffn_tf32_kernel<C, MT, true> writes h0, dres and
// dff in f32; (b) ffn_dup_tf32_kernel (64- or 32-row blocks, F in chunks of
// 16, W1 / W2f^T / W1^T pieces split at weight preparation); (c)
// ffn_dt1_kernel<float, CN>. No product is formed on a halo row.
//
// Weight gradients go to one zeroed f32 buffer by atomics, so their
// summation order changes from run to run (f32 order only); dz takes none.
//
// Shapes the kernels take: C in {32, 64, 128, 256}; F a multiple of 64;
// 1 <= k <= 63 in bf16 (the forward's t1 window), k <= 50 in f32 (the dt1
// tile).
#include "common.cuh"
#include "ffn_sm90.cuh"

namespace {

// the launches of the latest accepted call: per launch grid x, y, z,
// shared-memory bytes a block and rows of one item a block owns (the dup
// and dt1 passes)
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

// ============================ f32 route: split TF32 =========================
struct DupF32Args {
  const float* h0;   // (B, T, C), from the chain
  const float* dff;  // (B, T, C)
  const float* img;  // F / 16 chunks of a W1, a W2f^T and a W1^T piece (ops/ffn.py _f32_image)
  const float* b1;
  const int* seed;
  float* dacc;       // (B, T, C) out
  float* dw1;
  float* dw2f;
  float* db1;
  int T, F;
  unsigned threshold;
  float inv_keep;
};

// (b) in f32: ffn_dup_tf32_kernel<C, MT>, a block owns R = 32 MT rows of
// one item, h0 and dff in swizzled f32 tiles, and walks F in chunks of 16
// from chunk `rot` on (so that the blocks' weight-gradient reductions
// spread over the matrices). Per chunk:
//   warps 0-3: up = h0 @ W1 piece (buffer A)      16-row tiles, split as read
//   warps 4-7: dup_d = dff @ W2f^T piece (buffer B), the same tiles; handed
//              to the partner up warp through shared memory (barrier 1 + w)
//   warps 0-3: dup = keep1 relu' dup_d / (1 - r), up_d = keep1 relu(up) /
//              (1 - r); split into dacc's A fragments and into plain rows;
//              db1 from the unsplit dup
//   all:       dacc (R x C) += dup @ W1^T piece (buffer A, refilled with
//              W1^T once the up warps are done with W1)
//              dW1[:, chunk] += h0^T dup (m16 tiles of channels) and
//              dW2f[chunk, :] += up_d^T dff (32 channels a warp), over the
//              tile's rows, each tile added with vector reductions
// dacc sums over F in the block's fixed order, so dz is deterministic.
template <int C, int MT>
__global__ void __launch_bounds__(ffn::kThreads, 1)
ffn_dup_tf32_kernel(const __grid_constant__ DupF32Args a) {
  using namespace ffn;
  constexpr int R = 32 * MT, FC = kDupFC, P = piece_bytes(C, FC), LD = kStageLd;
  constexpr int WMU = R / 16, WNU = 4 / WMU, NTU = FC / 8 / WNU;  // a half's warps down, across
  constexpr int NT = C / 32;                                     // dacc: n8 tiles a warp
  constexpr int QW1 = (C / 16 + 7) / 8;                          // dW1: m16 tiles a warp
  extern __shared__ __align__(16) uint8_t smem[];
  const float4* bufA = reinterpret_cast<const float4*>(smem);
  const float4* bufB = reinterpret_cast<const float4*>(smem + P);
  float* h0s = reinterpret_cast<float*>(smem + 2 * P);
  float* dffs = h0s + R * C;
  float4* sd = reinterpret_cast<float4*>(dffs + R * C);  // dup as dacc's A fragments
  float* dup_hi = reinterpret_cast<float*>(sd + R * FC / 2);
  float* dup_lo = dup_hi + R * LD;
  float* upd_hi = dup_lo + R * LD;
  float* upd_lo = upd_hi + R * LD;
  float4* xch = reinterpret_cast<float4*>(upd_lo + R * LD);  // dup_d, up warp by up warp
  uint8_t* barp = reinterpret_cast<uint8_t*>(xch + R * FC / 4);
  const uint32_t base = smem_u32(smem);
  const Bars bars(smem_u32(barp), reinterpret_cast<uint32_t*>(barp + 16));
  const int T = a.T, b = blockIdx.y, t0 = blockIdx.x * R, nchunks = a.F / FC;
  const int rot = (blockIdx.x + blockIdx.y * gridDim.x) % nchunks;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint8_t* img = reinterpret_cast<const uint8_t*>(a.img);
  auto piece = [img](int ci, int m) { return img + (static_cast<size_t>(ci) * 3 + m) * P; };

  if (threadIdx.x == 0) {
    bars.init();
    bars.released[2] = 0u;
    load_bytes(bars, 0, base, piece(rot, 0), P);
    load_bytes(bars, 1, base + P, piece(rot, 1), P);
  }
  // the tile's h0 and dff rows into the swizzled tiles; zero beyond T
  {
    const size_t off = (static_cast<size_t>(b) * T + t0) * C;
    for (int idx = threadIdx.x; idx < R * (C / 4); idx += ffn::kThreads) {
      const int r = idx / (C / 4), c = 4 * (idx % (C / 4)), o = r * C + swz32(r, c);
      if (t0 + r < T) {
        cp_async16(smem_u32(h0s + o), a.h0 + off + static_cast<size_t>(r) * C + c);
        cp_async16(smem_u32(dffs + o), a.dff + off + static_cast<size_t>(r) * C + c);
      } else {
        *reinterpret_cast<float4*>(h0s + o) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        *reinterpret_cast<float4*>(dffs + o) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    cp_async_wait_all();
  }
  __syncthreads();

  const int half = warp >> 2, hw = warp & 3;
  const int um = hw % WMU, un = hw / WMU;      // rows 16 um, n8 tiles un NTU of the chunk
  const int fm = warp >> 2, fn = warp & 3;     // dacc: m16 tiles fm MT, n8 tiles fn NT
  const bool drop = a.threshold != 0u;
  const unsigned seed_b = lfs2::item_seed(*a.seed, b), thr = a.threshold;
  const float ik = a.inv_keep;
  const unsigned rh[2] = {row_hash(t0 + 16 * um + g), row_hash(t0 + 16 * um + g + 8)};
  float dacc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dacc[mt][nt][e] = 0.0f;

  for (int i = 0; i < nchunks; ++i) {
    const int ci = (i + rot) % nchunks, f0 = ci * FC;
    const int next = i + 1 < nchunks ? (i + 1 + rot) % nchunks : -1;
    if (half == 0) {
      // up (the relu and keep1 bits, and up_d for dW2f)
      float up[NTU][4];
      mbar_wait(bars.full1, 0u);  // buffer A's even phases: W1 pieces
      rows_x_piece<C, NTU, FC / 8>(up, h0s, 16 * um, bufA, un * NTU, lane);
      if (last_of(&bars.released[0], 4)) load_bytes(bars, 0, base, piece(ci, 2), P);
      asm volatile("bar.sync %0, 64;\n" ::"r"(1 + hw) : "memory");  // the partner's dup_d
#pragma unroll
      for (int nt = 0; nt < NTU; ++nt) {
        const int j = un * NTU + nt, fl = 8 * j + 2 * t, f = f0 + fl;
        const float4 d4 = xch[(hw * NTU + nt) * 32 + lane];
        const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
        const float2 bb = *reinterpret_cast<const float2*>(a.b1 + f);
        float ud[4], dp[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pre = up[nt][e] + ((e & 1) ? bb.y : bb.x);
          const bool keep = !drop || keep_h(rh[e >> 1], col_hash(f + (e & 1), 1u), seed_b, thr);
          const bool in = t0 + 16 * um + g + 8 * (e >> 1) < T;
          ud[e] = keep && in ? fmaxf(pre, 0.0f) * ik : 0.0f;
          dp[e] = keep && pre > 0.0f ? dd[e] * ik : 0.0f;
        }
        add_col_pair(a.db1 + f, dp[0] + dp[2], dp[1] + dp[3], lane);
        store_a_frag(sd + ((j * (R / 16) + um) * 32 + lane) * 2, dp);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int at = (16 * um + g + 8 * h) * LD + fl;
          uint32_t dh[2], dl[2], uh[2], ul[2];
          lfs2::split(dp[2 * h], dh[0], dl[0]);
          lfs2::split(dp[2 * h + 1], dh[1], dl[1]);
          lfs2::split(ud[2 * h], uh[0], ul[0]);
          lfs2::split(ud[2 * h + 1], uh[1], ul[1]);
          *reinterpret_cast<float2*>(dup_hi + at) = make_float2(__uint_as_float(dh[0]), __uint_as_float(dh[1]));
          *reinterpret_cast<float2*>(dup_lo + at) = make_float2(__uint_as_float(dl[0]), __uint_as_float(dl[1]));
          *reinterpret_cast<float2*>(upd_hi + at) = make_float2(__uint_as_float(uh[0]), __uint_as_float(uh[1]));
          *reinterpret_cast<float2*>(upd_lo + at) = make_float2(__uint_as_float(ul[0]), __uint_as_float(ul[1]));
        }
      }
    } else {
      // dup_d = dff @ W2fc^T, handed to the up warp of the same tiles
      float dd[NTU][4];
      mbar_wait(bars.full2, i & 1);
      rows_x_piece<C, NTU, FC / 8>(dd, dffs, 16 * um, bufB, un * NTU, lane);
      if (last_of(&bars.released[1], 4) && next >= 0) load_bytes(bars, 1, base + P, piece(next, 1), P);
#pragma unroll
      for (int nt = 0; nt < NTU; ++nt)
        xch[(hw * NTU + nt) * 32 + lane] = make_float4(dd[nt][0], dd[nt][1], dd[nt][2], dd[nt][3]);
      asm volatile("bar.arrive %0, 64;\n" ::"r"(1 + hw) : "memory");
    }
    __syncthreads();  // the chunk's stagings are complete

    // dacc += dup @ W1c^T
    mbar_wait(bars.full1, 1u);  // buffer A's odd phases: W1^T pieces
    frags_x_piece<MT, NT, FC / 8, R / 16, C / 8>(dacc, sd, fm * MT, bufA, fn * NT, lane);
    if (last_of(&bars.released[2], 8) && next >= 0) load_bytes(bars, 0, base, piece(next, 0), P);

    // dW1[c, chunk] += sum_r h0[r, c] dup[r, f]: m16 tiles of channels
    {
      float acc[QW1][2][4];
#pragma unroll
      for (int q = 0; q < QW1; ++q)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][nt][e] = 0.0f;
      if (warp < C / 16) {
#pragma unroll 2
        for (int s = 0; s < R / 8; ++s) {
          const int r0 = 8 * s + 2 * t;
          uint32_t bh[2][2], bl[2][2];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              bh[nt][e] = __float_as_uint(dup_hi[(r0 + e) * LD + 8 * nt + g]);
              bl[nt][e] = __float_as_uint(dup_lo[(r0 + e) * LD + 8 * nt + g]);
            }
#pragma unroll
          for (int q = 0; q < QW1; ++q) {
            const int c0 = 16 * (warp + 8 * q);
            uint32_t ah[4], al[4];
            lfs2::split_a(h0s[r0 * C + swz32(r0, c0 + g)], h0s[r0 * C + swz32(r0, c0 + g + 8)],
                          h0s[(r0 + 1) * C + swz32(r0 + 1, c0 + g)],
                          h0s[(r0 + 1) * C + swz32(r0 + 1, c0 + g + 8)], ah, al);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) lfs2::mma3(acc[q][nt], ah, al, bh[nt], bl[nt]);
          }
        }
#pragma unroll
        for (int q = 0; q < QW1; ++q)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) red_tile(a.dw1, a.F, acc[q][nt], 16 * (warp + 8 * q), f0 + 8 * nt, lane);
      }
    }
    // dW2f[chunk, c] += sum_r up_d[r, f] dff[r, c]: 32 channels a warp
    if (warp < C / 32) {
      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll 2
      for (int s = 0; s < R / 8; ++s) {
        const int r0 = 8 * s + 2 * t;
        uint32_t ah[4], al[4];
        // (f g, r 2t), (f g + 8, r 2t), (f g, r 2t + 1), (f g + 8, r 2t + 1)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int at = (r0 + (q >> 1)) * LD + g + 8 * (q & 1);
          ah[q] = __float_as_uint(upd_hi[at]);
          al[q] = __float_as_uint(upd_lo[at]);
        }
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = 32 * warp + 8 * nt + g;
          lfs2::split(dffs[r0 * C + swz32(r0, c)], bh[nt][0], bl[nt][0]);
          lfs2::split(dffs[(r0 + 1) * C + swz32(r0 + 1, c)], bh[nt][1], bl[nt][1]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) lfs2::mma_tf32(acc[nt], ah, bl[nt]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) lfs2::mma_tf32(acc[nt], al, bh[nt]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) lfs2::mma_tf32(acc[nt], ah, bh[nt]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) red_tile(a.dw2f, C, acc[nt], f0, 32 * warp + 8 * nt, lane);
    }
    __syncthreads();  // the stagings are free for the next chunk
  }

  const size_t row0 = static_cast<size_t>(b) * T + t0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * (fm * MT + mt) + g + 8 * h, c = 8 * (fn * NT + nt) + 2 * t;
        if (t0 + r < T)
          *reinterpret_cast<float2*>(a.dacc + (row0 + r) * C + c) =
              make_float2(dacc[mt][nt][2 * h], dacc[mt][nt][2 * h + 1]);
      }
}

template <int C, int MT>
cudaError_t dup_f32_launch(const DupF32Args& a, int B, cudaStream_t s) {
  const int smem = ffn::f32_dup_smem(32 * MT, C);
  auto kernel = ffn_dup_tf32_kernel<C, MT>;
  cudaError_t err = lfs2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + 32 * MT - 1) / (32 * MT), B);
  kernel<<<grid, ffn::kThreads, smem, s>>>(a);
  return record_launch(0, grid, smem, 32 * MT);
}

template <int C>
cudaError_t dup_f32_rows(const DupF32Args& a, int B, int rows, cudaStream_t s) {
  switch (rows) {
    case 32: return dup_f32_launch<C, 1>(a, B, s);
    case 64: return dup_f32_launch<C, 2>(a, B, s);
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

template <typename TW>
struct Dt1Args {
  const TW* z;
  const float* dres;
  const float* dacc;
  const float* wd;
  const float* lnp;
  TW* dz;
  float* dwd;
  float* dvec;
  int T, k;
  float eps;
};

// four consecutive t1 values as floats
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// (c), both routes: a block owns kDt1Rows rows of one item; dacc over them
// and the k - 1 rows the depthwise backward reaches (f32), t1 over the rows
// the dwd sums reach (recomputed from z and rounded to the working dtype TW,
// as the forward formed it)
template <typename TW, int CN>
__global__ void __launch_bounds__(ffn::kDt1Threads)
ffn_dt1_kernel(const __grid_constant__ Dt1Args<TW> a) {
  constexpr int C = 32 * CN, TC = ffn::kDt1Rows, NW = ffn::kDt1Threads / 32, RPW = TC / NW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = a.k, T = a.T, lpad = (k - 1) / 2, rpad = k - 1 - lpad, Wn = TC + k - 1;
  float* dw = reinterpret_cast<float*>(smem_raw);      // dacc rows t0 - rpad ..
  TW* t1w = reinterpret_cast<TW*>(dw + Wn * C);          // t1 rows t0 - lpad ..
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
      t1w[r * C + c] = lfs2::from_f<TW>(in ? ffn::ln_apply(v[i], mean, inv, g1[c], be1[c]) : 0.0f);
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
      const float4 t = j < k ? load4(t1w + (r + j) * C + c) : make_float4(1.0f, 1.0f, 1.0f, 1.0f);
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
      a.dz[o + c] = lfs2::from_f<TW>(inv * (dt[rr][i] * g1[c] - m1 - x[i] * m2));
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

template <typename TW, int CN>
cudaError_t dt1_launch(const Dt1Args<TW>& a, int B, cudaStream_t s) {
  const int smem = ffn::dt1_smem(32 * CN, a.k, static_cast<int>(sizeof(TW)));
  if (smem > ffn::kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = ffn_dt1_kernel<TW, CN>;
  cudaError_t err = lfs2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + ffn::kDt1Rows - 1) / ffn::kDt1Rows, B);
  kernel<<<grid, ffn::kDt1Threads, smem, s>>>(a);
  return record_launch(1, grid, smem, ffn::kDt1Rows);
}

cudaError_t bf16_dup(int C, const DupArgs& d, int B, cudaStream_t s) {
  switch (C) {
    case 32:
    case 64: return dup_launch<64>(d, B, s);
    case 128: return dup_launch<128>(d, B, s);
    case 256: return dup_launch<256>(d, B, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t f32_dup(int C, const DupF32Args& d, int B, int rows, cudaStream_t s) {
  switch (C) {
    case 32: return dup_f32_rows<32>(d, B, rows, s);
    case 64: return dup_f32_rows<64>(d, B, rows, s);
    case 128: return dup_f32_rows<128>(d, B, rows, s);
    case 256: return dup_f32_rows<256>(d, B, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TW>
cudaError_t dt1(int C, const Dt1Args<TW>& t, int B, cudaStream_t s) {
  switch (C) {
    case 32: return dt1_launch<TW, 1>(t, B, s);
    case 64: return dt1_launch<TW, 2>(t, B, s);
    case 128: return dt1_launch<TW, 4>(t, B, s);
    case 256: return dt1_launch<TW, 8>(t, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

LFS2_DEFINE_ERROR_STRING

// The backward's stages (b) and (c), after ffn_ln.cu's lfs2_ffn_ln_chain
// wrote h0, dres and dff (and dg2, dbe2, db2f into dvec), in the working
// dtype (h0, dff, z, dz; dres f32). img: bf16 the swizzled image (the
// chain's), f32 the dup pass's pieces (ops/ffn.py _f32_image). dacc is
// (B, T, C) f32 scratch; dwd, dw1, dw2f, db1 and dvec are zeroed f32
// buffers; rows: the dup pass's rows a block (128 in bf16, 32 or 64 in f32)
LFS2_EXPORT int lfs2_ffn_ln_train_bwd(const void* z, const float* dres, const void* h0,
                                      const void* dff, const float* wd, const void* img,
                                      const float* b1, const float* lnp, const int* seed,
                                      float* dacc, void* dz, float* dwd, float* dw1, float* dw2f,
                                      float* db1, float* dvec, int B, int T_len, int C, int F,
                                      int k, int rows, float eps, unsigned threshold,
                                      float inv_keep, int dtype, void* stream) {
  if (F % ffn::kFC != 0 || B < 1 || T_len < 1 || k < 1 ||
      k > (dtype == lfs2::kBF16 ? ffn::kMaxK : ffn::kMaxKF32))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == lfs2::kBF16) {
    if (rows != ffn::kRows) return static_cast<int>(cudaErrorInvalidValue);
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
    err = bf16_dup(C, d, B, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const Dt1Args<bf16> t{static_cast<const bf16*>(z), dres, dacc, wd, lnp, static_cast<bf16*>(dz),
                          dwd, dvec, T_len, k, eps};
    return static_cast<int>(dt1(C, t, B, s));
  }
  const DupF32Args d{static_cast<const float*>(h0), static_cast<const float*>(dff),
                     static_cast<const float*>(img), b1, seed, dacc, dw1, dw2f, db1, T_len, F,
                     threshold, inv_keep};
  err = f32_dup(C, d, B, rows, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Dt1Args<float> t{static_cast<const float*>(z), dres, dacc, wd, lnp, static_cast<float*>(dz),
                         dwd, dvec, T_len, k, eps};
  return static_cast<int>(dt1(C, t, B, s));
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
// the latest accepted call's launches: the dup pass, then the dt1 pass
LFS2_EXPORT int lfs2_ffn_ln_train_bwd_last_launches(int* out) {
  for (int i = 0; i < 10; ++i) out[i] = g_last_launch[i / 5][i % 5];
  return 0;
}

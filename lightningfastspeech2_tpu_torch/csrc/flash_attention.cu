// flash_attention, f32 route: softmax(q k^T / sqrt(d)) v with a key-padding
// mask and hashed dropout on the probabilities, forward and backward, on
// Hopper's tensor cores with split-TF32 products. bf16 inputs take
// flash_attention_sm90.cu (wgmma).
//
// Replaces lightningfastspeech2_tpu/ops/pallas_attention.py _fwd_kernel and
// _bwd_kernel (flash_attention, joined by a custom VJP there and by an
// autograd Function here). q, k, v, o, do are (B, H, T, D) f32 with head dim
// D = 128 or 256 (the kernels are templates on D); mask is
// (B, T) int32, nonzero = valid key. Padded queries are not masked (torch
// key_padding_mask semantics); a padded key's score is -1e30, as there. An
// item with no valid key scores every key 0 instead: the same uniform
// softmax the JAX kernel gives, with a log-sum-exp the backward can use. A
// padded key's score is a constant, so its dS is 0 (the function's gradient
// and the plain version's).
//
// Products. One TF32 product keeps 11 bits of each operand, about three
// digits. Split products keep f32's: each operand is split as x = hi + lo,
// hi = tf32(x) and lo = tf32(x - hi) (cvt.rna), and a b is formed as
// a_hi b_lo + a_lo b_hi + a_hi b_hi with f32 accumulation (CUTLASS's
// OpMultiplyAddFastF32); the dropped a_lo b_lo is below 2^-22 of a b. Each
// product is three mma.sync.m16n8k8 tf32 instructions. A block's own 32
// rows (Q and dO in the forward and dQ pass, K and V in the dK/dV pass) are
// split once, into shared memory in fragment order (one 16-byte load gives
// a thread its four A values, hi or lo). The streamed tiles land raw
// through cp.async and are split in registers as B fragments are loaded:
// splitting them in shared memory would add a pass over each tile and a
// barrier, for conversions that cost two cvt and a subtract per value.
//
// Tiling. A block owns 32 rows (the grid is T/32 x H x B: 128 blocks at
// (2, 2, 1024, 128)) and streams the other operand in 64-row tiles through
// a 2-stage cp.async ring, so the next tile's copy overlaps this tile's
// products. Its 8 warps are 2 row tiles of 16 by 4 column quarters of 16:
// a warp forms its 16 x 16 scores and then multiplies them, as they are
// in its registers, into a 16 x 128 f32 accumulator over its own 16
// columns (the products' k order is permuted so that an mma's C fragment is
// the next mma's A fragment: k position t holds column 2t, t + 4 column
// 2t + 1). The four column quarters' partial sums (and, in the forward,
// their running max and denominator) are combined in shared memory once,
// at the end. Key tiles past the item's last valid key are skipped: a
// padded key's probability is exactly 0 there, and its dK and dV too.
//
// Forward: online softmax per warp; the running denominator sums the
// UNDROPPED p, only the kept p enters the accumulator, and the output is
// acc / (denom * (1 - rate)), as at pallas_attention.py:124. The f32
// log-sum-exp m + log(denom) per row is saved for the backward.
//
// Backward: a dQ pass (one block per 32 query rows, keys streamed) first
// forms D_i = rowsum(dO o O), which equals sum_j p_ij dp_ij with dropout
// too, and a K-major pass (one block per 32 keys, queries streamed) forms
// dK and dV. Both recompute P from the saved log-sum-exp and the dropout
// mask from the hash; neither takes atomics, so the backward repeats bit
// for bit.
//
// Dropout: keep(query row r, key c) hashes the GLOBAL coordinates with
// seed_bh = seed + b * H + h (lfs2::attn_keep, bit for bit
// pallas_attention.py _dropout_keep), so every tiling agrees.
//
// At D = 256 a streamed tile of K and V is 133 KB, so the ring has one
// stage (the next tile's copy waits for this tile's products); the dQ and
// dK/dV passes keep their own rows raw in fragment order and split them as
// they are read (split, Q and dO alone are 128 KB); and the dK/dV pass gives
// each 32 keys two blocks, one forming dV and one dK, since one thread
// cannot hold both 16 x 256 accumulators.
//
// What bounds it on an H100: operations. 4 T^2 d per (b, h) forward and 5
// products backward (the split backward forms S and dP twice: 7), each
// split product three TF32 products: at 495 TFLOP/s of dense TF32 that is
// 3 x ops / 495 TFLOP/s, against ops / 67 TFLOP/s on the CUDA cores.
#include "common.cuh"
#include "mma.cuh"

#include <cstdint>

namespace {

constexpr int BM = 32;        // a block's own rows
constexpr int BN = 64;        // rows of a streamed tile
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;

// The geometry of head dim D (128 or 256)
template <int D> struct Geo {
  static constexpr int LDS = D + 4;   // row stride (floats) of a streamed tile: conflict-free B fragments
  static constexpr int LDO = D == 128 ? D + 8 : D + 4;  // the end-of-block reduction buffers
  static constexpr int kFrag = BM * D;  // floats of one fragment-ordered half (hi or lo, or raw)
  static constexpr int kTile = BN * LDS;
  static constexpr int kStages = D == 128 ? 2 : 1;   // the streamed tiles' ring
  static constexpr bool kSplitOwn = D == 128;        // dQ and dK/dV: own rows split once
  static constexpr bool kBothKV = D == 128;          // dK/dV: one block forms both
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const int* mask;
  const int* seed;
  const float* o;
  const float* dout;
  float* out;     // o (forward) or dq (backward dQ pass)
  float* lse;
  float* dsum;    // D_i, written by the dQ pass
  float* dk;
  float* dv;
  int H, T;
  float scale;
  unsigned threshold;
  float inv_keep;
};

// split-TF32 products and cp.async (csrc/mma.cuh)
using lfs2::cp_async16;
using lfs2::cp_async_commit;
using lfs2::cp_async_wait;
using lfs2::mma3;
using lfs2::mma_tf32;
using lfs2::split;
using lfs2::tf32;

// rows [r0, r0 + 64) of a (T, D) slab into a [64][LDS] tile, asynchronously
template <int D> __device__ __forceinline__ void issue_tile(const float* x, int r0, float* dst) {
  for (int idx = threadIdx.x; idx < BN * D / 4; idx += kThreads) {
    const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
    cp_async16(dst + r * Geo<D>::LDS + c, x + static_cast<size_t>(r0 + r) * D + c);
  }
}

// 64 floats from x + r0 into dst, asynchronously
__device__ __forceinline__ void issue_row_vec(const float* x, int r0, float* dst) {
  if (threadIdx.x < BN / 4) cp_async16(dst + threadIdx.x * 4, x + r0 + threadIdx.x * 4);
}

// Where element (r, c) of a 32 x D operand sits in fragment order: per 16-row
// tile and 8-column k-step, 32 lanes of {a0, a1, a2, a3} = (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4) with g = lane / 4, t = lane % 4.
template <int D> __device__ __forceinline__ int frag_at(int r, int c) {
  const int rr = r & 15, cc = c & 7;
  const int lane = (rr & 7) * 4 + (cc & 3);
  const int reg = (rr >> 3) + 2 * (cc >> 2);
  return ((((r >> 4) * (D / 8) + (c >> 3)) * 32 + lane) << 2) + reg;
}

// rows [r0, r0 + 32) of a (T, D) slab, fragment-ordered: split into hi and
// lo (kSplit), or raw into hi (lo unused)
template <int D, bool kSplit>
__device__ __forceinline__ void load_split_rows(const float* x, int r0, float* hi, float* lo) {
  for (int idx = threadIdx.x; idx < BM * D / 4; idx += kThreads) {
    const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(x + static_cast<size_t>(r0 + r) * D + c);
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int at = frag_at<D>(r, c + i);
      if constexpr (kSplit) {
        const float h = tf32(e[i]);
        hi[at] = h;
        lo[at] = tf32(e[i] - h);
      } else {
        hi[at] = e[i];
      }
    }
  }
}

// the A fragment (hi, lo) of row tile mt at k-step ks, from split halves or
// split here from the raw values in hi
template <int D, bool kSplit>
__device__ __forceinline__ void load_a(const float* hi, const float* lo, int mt, int ks, int lane,
                                       uint32_t ah[4], uint32_t al[4]) {
  const int at = (mt * (D / 8) + ks) * 32 + lane;
  if constexpr (kSplit) {
    const uint4 h = reinterpret_cast<const uint4*>(hi)[at];
    const uint4 l = reinterpret_cast<const uint4*>(lo)[at];
    ah[0] = h.x; ah[1] = h.y; ah[2] = h.z; ah[3] = h.w;
    al[0] = l.x; al[1] = l.y; al[2] = l.z; al[3] = l.w;
  } else {
    const float4 v = reinterpret_cast<const float4*>(hi)[at];
    lfs2::split_a(v.x, v.y, v.z, v.w, ah, al);
  }
}

// acc[j] += X Y^T at k-step ks (8 of the D columns) for the warp's 16 rows
// of X (fragment-ordered) and the 16 rows [n0, n0 + 16) of a streamed tile Y
template <int D, bool kSplit>
__device__ __forceinline__ void score_step(const float* xh, const float* xl, int mt, int ks,
                                           const float* Y, int n0, int lane, float acc[2][4]) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t ah[4], al[4];
  load_a<D, kSplit>(xh, xl, mt, ks, lane, ah, al);
  uint32_t bh[2][2], bl[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float* y = Y + (n0 + 8 * j + g) * Geo<D>::LDS + 8 * ks + t;
    split(y[0], bh[j][0], bl[j][0]);
    split(y[4], bh[j][1], bl[j][1]);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) mma_tf32(acc[j], ah, bl[j]);
#pragma unroll
  for (int j = 0; j < 2; ++j) mma_tf32(acc[j], al, bh[j]);
#pragma unroll
  for (int j = 0; j < 2; ++j) mma_tf32(acc[j], ah, bh[j]);
}

// Two score products over d < D in one loop, so that their mma chains
// interleave: acc0 += X0 Y0^T over k-steps ks0, ks0 + step, ..., acc1 +=
// X1 Y1^T over ks1, ks1 + step, ... (two products with step 1, or the even
// and odd k-steps of one with step 2)
template <int D, bool kSplit>
__device__ __forceinline__ void scores2(const float* x0h, const float* x0l, const float* y0,
                                        int ks0, const float* x1h, const float* x1l,
                                        const float* y1, int ks1, int step, int mt, int n0,
                                        int lane, float acc0[2][4], float acc1[2][4]) {
#pragma unroll 2
  for (int ks = 0; ks < D / 8; ks += step) {
    score_step<D, kSplit>(x0h, x0l, mt, ks + ks0, y0, n0, lane, acc0);
    score_step<D, kSplit>(x1h, x1l, mt, ks + ks1, y1, n0, lane, acc1);
  }
}

// acc[n] += P Z for the warp's 16 x 16 block P (C fragments of scores(),
// split) and rows [c0, c0 + 16) of a streamed tile Z, all D columns; k
// position t of each 8-column step is column 2t, t + 4 is 2t + 1
template <int D>
__device__ __forceinline__ void accumulate(const uint32_t ph[2][4], const uint32_t pl[2][4],
                                           const float* Z, int c0, int lane, float (&acc)[D / 8][4]) {
  constexpr int LDS = Geo<D>::LDS;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint32_t ah[4] = {ph[j][0], ph[j][2], ph[j][1], ph[j][3]};
    const uint32_t al[4] = {pl[j][0], pl[j][2], pl[j][1], pl[j][3]};
    const float* z = Z + (c0 + 8 * j + 2 * t) * LDS + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t bh[2], bl[2];
      split(z[8 * n], bh[0], bl[0]);
      split(z[8 * n + LDS], bh[1], bl[1]);
      mma3(acc[n], ah, al, bh, bl);
    }
  }
}

// Sum the four column quarters' 32 x D partial accumulators (each row
// scaled by the thread's row_scale) through buf [4][32][LDO] and store the
// sum to rows [r0, r0 + 32) of out. Every thread of the block calls it.
template <int D>
__device__ __forceinline__ void reduce_store(const float (&acc)[D / 8][4], const float row_scale[2],
                                             float* buf, float* out, int r0) {
  constexpr int LDO = Geo<D>::LDO;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp & 1, wn = warp >> 1;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * wm + g + 8 * hh;
      *reinterpret_cast<float2*>(buf + (wn * BM + r) * LDO + 8 * n + 2 * t) =
          make_float2(acc[n][2 * hh] * row_scale[hh], acc[n][2 * hh + 1] * row_scale[hh]);
    }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * D / 4; idx += kThreads) {
    const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(buf + (w * BM + r) * LDO + c);
      s.x += x.x; s.y += x.y; s.z += x.z; s.w += x.w;
    }
    *reinterpret_cast<float4*>(out + static_cast<size_t>(r0 + r) * D + c) = s;
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned seed_bh(const Params& p, int b, int h) {
  return static_cast<unsigned>(*p.seed) + static_cast<unsigned>(b * p.H + h);
}

// The score of a padded key (-1e30, or 0 when the item has no valid key)
// and, in kend, the end of the item's last valid key (T when there is
// none). Every thread of the block calls it.
__device__ __forceinline__ float key_extent(const int* mask, int T_len, int* kend) {
  __shared__ int s_last;
  if (threadIdx.x == 0) s_last = -1;
  __syncthreads();
  int last = -1;
  for (int i = threadIdx.x; i < T_len; i += kThreads)
    if (mask[i]) last = i;
  last = __reduce_max_sync(0xffffffffu, last);
  if ((threadIdx.x & 31) == 0) atomicMax(&s_last, last);
  __syncthreads();
  *kend = s_last < 0 ? T_len : s_last + 1;
  return s_last < 0 ? 0.0f : kNeg;
}

// The ring of streamed tiles: with two stages the next tile's copy is issued
// before this tile's products; with one it is issued after them.
template <int D> struct Ring {
  static constexpr int kStages = Geo<D>::kStages;
  // before tile it's products: issue tile it + 1 (two stages), then wait for
  // tile it; `issue(i, dst)` copies tile i into a stage
  template <typename F>
  static __device__ __forceinline__ float* acquire(int it, int n_tiles, float* ring, int stage_floats,
                                                   F issue) {
    if constexpr (kStages == 2) {
      if (it + 1 < n_tiles) issue(it + 1, ring + ((it + 1) & 1) * stage_floats);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    return ring + (kStages == 2 ? (it & 1) * stage_floats : 0);
  }
  // after tile it's products: the stage may be refilled
  template <typename F>
  static __device__ __forceinline__ void release(int it, int n_tiles, float* ring, F issue) {
    __syncthreads();
    if constexpr (kStages == 1) {
      if (it + 1 < n_tiles) issue(it + 1, ring);
      cp_async_commit();
    }
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1) fwd_kernel(Params p) {
  constexpr int kFrag = Geo<D>::kFrag, kTile = Geo<D>::kTile;
  extern __shared__ __align__(16) float smem[];
  float* Qh = smem;
  float* Ql = Qh + kFrag;
  float* ring = Ql + kFrag;   // stage s: K tile at ring + 2 s kTile, V tile after it
  __shared__ float s_m[8][16], s_l[8][16];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM, T_len = p.T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp & 1, wn = warp >> 1;
  const size_t base = (static_cast<size_t>(b) * p.H + h) * T_len * D;
  const float* q = p.q + base;
  const float* k = p.k + base;
  const float* v = p.v + base;
  const int* mask = p.mask + static_cast<size_t>(b) * T_len;
  const unsigned sbh = seed_bh(p, b, h);
  const bool drop = p.threshold != 0u;
  int kend;
  const float mval = key_extent(mask, T_len, &kend);
  const int n_tiles = (kend + BN - 1) / BN;
  auto issue = [&](int i, float* dst) {
    issue_tile<D>(k, i * BN, dst);
    issue_tile<D>(v, i * BN, dst + kTile);
  };

  issue(0, ring);
  cp_async_commit();
  load_split_rows<D, true>(q, q0, Qh, Ql);

  float o[D / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.0f;
  const int row0 = q0 + 16 * wm + g;   // this thread's rows: row0 and row0 + 8
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BN;
    const float* Ks = Ring<D>::acquire(it, n_tiles, ring, 2 * kTile, issue);
    const float* Vs = Ks + kTile;
    float sb[2][4] = {}, so[2][4] = {};   // even and odd k-steps
    scores2<D, true>(Qh, Ql, Ks, 0, Qh, Ql, Ks, 1, 2, wm, 16 * wn, lane, sb, so);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = k0 + 16 * wn + 8 * j + 2 * t + (i & 1);
        sb[j][i] = __ldg(mask + c) ? (sb[j][i] + so[j][i]) * p.scale : mval;
        mx[i >> 1] = fmaxf(mx[i >> 1], sb[j][i]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = __expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    uint32_t ph[2][4], pl[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float pv = __expf(sb[j][i] - m[i >> 1]);
        l[i >> 1] += pv;
        if (drop && !lfs2::attn_keep(row0 + 8 * (i >> 1), k0 + 16 * wn + 8 * j + 2 * t + (i & 1),
                                     sbh, p.threshold))
          pv = 0.0f;
        split(pv, ph[j][i], pl[j][i]);
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
      o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
    }
    accumulate<D>(ph, pl, Vs, 16 * wn, lane, o);
    Ring<D>::release(it, n_tiles, ring, issue);   // the stage is refilled next tile
  }
  cp_async_wait<0>();

  // combine the four key quarters: max, denominators, then the outputs
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (t == 0) {
      s_m[warp][g + 8 * r] = m[r];
      s_l[warp][g + 8 * r] = l[r];
    }
  }
  __syncthreads();
  float row_scale[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) M = fmaxf(M, s_m[2 * w + wm][g + 8 * r]);
    float L = 0.0f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int at = 2 * w + wm;
      L += s_l[at][g + 8 * r] * __expf(s_m[at][g + 8 * r] - M);
    }
    row_scale[r] = __expf(m[r] - M) * (drop ? p.inv_keep : 1.0f) / L;
    if (wn == 0 && t == 0)
      p.lse[(static_cast<size_t>(b) * p.H + h) * T_len + row0 + 8 * r] = M + logf(L);
  }
  reduce_store<D>(o, row_scale, ring, p.out + base, q0);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(Params p) {
  constexpr int kFrag = Geo<D>::kFrag, kTile = Geo<D>::kTile;
  constexpr bool kSplit = Geo<D>::kSplitOwn;
  constexpr int kHalves = kSplit ? 2 : 1;  // hi and lo, or raw
  extern __shared__ __align__(16) float smem[];
  float* Qh = smem;
  float* Ql = Qh + kFrag;
  float* dOh = Qh + kHalves * kFrag;
  float* dOl = dOh + kFrag;
  float* ring = dOh + kHalves * kFrag;  // stage s: K tile at ring + 2 s kTile, V tile after it
  __shared__ float s_lse[BM], s_dsum[BM];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM, T_len = p.T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp & 1, wn = warp >> 1;
  const size_t base = (static_cast<size_t>(b) * p.H + h) * T_len * D;
  const size_t row_base = (static_cast<size_t>(b) * p.H + h) * T_len;
  const float* q = p.q + base;
  const float* k = p.k + base;
  const float* v = p.v + base;
  const float* o = p.o + base;
  const float* dout = p.dout + base;
  const int* mask = p.mask + static_cast<size_t>(b) * T_len;
  const unsigned sbh = seed_bh(p, b, h);
  const bool drop = p.threshold != 0u;
  int kend;
  const float mval = key_extent(mask, T_len, &kend);
  const int n_tiles = (kend + BN - 1) / BN;
  auto issue = [&](int i, float* dst) {
    issue_tile<D>(k, i * BN, dst);
    issue_tile<D>(v, i * BN, dst + kTile);
  };

  issue(0, ring);
  cp_async_commit();
  load_split_rows<D, kSplit>(q, q0, Qh, Ql);
  load_split_rows<D, kSplit>(dout, q0, dOh, dOl);
  // D_i = rowsum(dO o O) from the f32 output, one warp per row
  for (int r = warp; r < BM; r += kThreads / 32) {
    float s = 0.0f;
#pragma unroll
    for (int c = lane * 4; c < D; c += 128) {
      const size_t at = static_cast<size_t>(q0 + r) * D + c;
      const float4 a = *reinterpret_cast<const float4*>(dout + at);
      const float4 x = *reinterpret_cast<const float4*>(o + at);
      s += a.x * x.x + a.y * x.y + a.z * x.z + a.w * x.w;
    }
    s = lfs2::warp_sum(s);
    if (lane == 0) {
      s_dsum[r] = s;
      p.dsum[row_base + q0 + r] = s;
      s_lse[r] = p.lse[row_base + q0 + r];
    }
  }
  __syncthreads();
  const int rl = 16 * wm + g;   // this thread's rows (block-local): rl and rl + 8
  const float lse_r[2] = {s_lse[rl], s_lse[rl + 8]};
  const float dsum_r[2] = {s_dsum[rl], s_dsum[rl + 8]};

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[n][i] = 0.0f;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BN;
    const float* Ks = Ring<D>::acquire(it, n_tiles, ring, 2 * kTile, issue);
    const float* Vs = Ks + kTile;
    float s[2][4] = {}, dp[2][4] = {};
    scores2<D, kSplit>(Qh, Ql, Ks, 0, dOh, dOl, Vs, 0, 1, wm, 16 * wn, lane, s, dp);
    uint32_t dh[2][4], dl[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = k0 + 16 * wn + 8 * j + 2 * t + (i & 1), hh = i >> 1;
        const bool valid = __ldg(mask + c) != 0;
        const float pv = __expf((valid ? s[j][i] * p.scale : mval) - lse_r[hh]);
        float dpv = dp[j][i];
        if (drop)
          dpv = lfs2::attn_keep(q0 + rl + 8 * hh, c, sbh, p.threshold) ? dpv * p.inv_keep : 0.0f;
        split(valid ? pv * (dpv - dsum_r[hh]) * p.scale : 0.0f, dh[j][i], dl[j][i]);
      }
    accumulate<D>(dh, dl, Ks, 16 * wn, lane, dq);
    Ring<D>::release(it, n_tiles, ring, issue);
  }
  cp_async_wait<0>();
  const float one[2] = {1.0f, 1.0f};
  reduce_store<D>(dq, one, ring, p.out + base, q0);
}

// grid (T / 32, H, B) at D = 128, each block forming dK and dV of its 32
// keys; (2 T / 32, H, B) at D = 256, block 2 i + 1 forming dK and 2 i dV of
// keys [32 i, 32 i + 32)
template <int D>
__global__ void __launch_bounds__(kThreads, 1) dkv_kernel(Params p) {
  constexpr int kFrag = Geo<D>::kFrag, kTile = Geo<D>::kTile;
  constexpr bool kSplit = Geo<D>::kSplitOwn, kBoth = Geo<D>::kBothKV;
  constexpr int kHalves = kSplit ? 2 : 1;
  extern __shared__ __align__(16) float smem[];
  float* Kh = smem;
  float* Kl = Kh + kFrag;
  float* Vh = Kh + kHalves * kFrag;
  float* Vl = Vh + kFrag;
  float* ring = Vh + kHalves * kFrag;   // stage s: Q tile, dO tile, lse[64], dsum[64]
  constexpr int kStage = 2 * kTile + 2 * BN;
  // 0: dV alone, 1: dK alone, 2: both
  const int which = kBoth ? 2 : static_cast<int>(blockIdx.x & 1);

  const int b = blockIdx.z, h = blockIdx.y, T_len = p.T;
  const int k0 = (kBoth ? blockIdx.x : blockIdx.x >> 1) * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp & 1, wn = warp >> 1;
  const size_t base = (static_cast<size_t>(b) * p.H + h) * T_len * D;
  const size_t row_base = (static_cast<size_t>(b) * p.H + h) * T_len;
  const float* q = p.q + base;
  const float* k = p.k + base;
  const float* v = p.v + base;
  const float* dout = p.dout + base;
  const int* mask = p.mask + static_cast<size_t>(b) * T_len;
  const unsigned sbh = seed_bh(p, b, h);
  const bool drop = p.threshold != 0u;
  int kend;
  const float mval = key_extent(mask, T_len, &kend);
  if (k0 >= kend) {
    // every key of the block lies past the item's last valid key: P and dS
    // are 0 on these keys, and so are dK and dV
    for (int idx = threadIdx.x; idx < BM * D / 4; idx += kThreads) {
      const size_t at = static_cast<size_t>(k0) * D + idx * 4;
      if (which != 0) *reinterpret_cast<float4*>(p.dk + base + at) = make_float4(0.f, 0.f, 0.f, 0.f);
      if (which != 1) *reinterpret_cast<float4*>(p.dv + base + at) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  // this thread's keys: c0 and c0 + 8
  const int c0 = k0 + 16 * wm + g;
  const bool valid[2] = {mask[c0] != 0, mask[c0 + 8] != 0};
  const int n_tiles = T_len / BN;
  auto issue = [&](int i, float* dst) {
    issue_tile<D>(q, i * BN, dst);
    issue_tile<D>(dout, i * BN, dst + kTile);
    issue_row_vec(p.lse + row_base, i * BN, dst + 2 * kTile);
    issue_row_vec(p.dsum + row_base, i * BN, dst + 2 * kTile + BN);
  };

  issue(0, ring);
  cp_async_commit();
  load_split_rows<D, kSplit>(k, k0, Kh, Kl);
  load_split_rows<D, kSplit>(v, k0, Vh, Vl);

  // dV, or dK alone (which == 1); dK beside dV when one block forms both
  float acc[D / 8][4], dk2[kBoth ? D / 8 : 1][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;
#pragma unroll
  for (int n = 0; n < (kBoth ? D / 8 : 1); ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk2[n][i] = 0.0f;
  for (int it = 0; it < n_tiles; ++it) {
    const int r0 = it * BN;
    const float* Qs = Ring<D>::acquire(it, n_tiles, ring, kStage, issue);
    const float* dOs = Qs + kTile;
    const float* lse = dOs + kTile;
    const float* dsum = lse + BN;
    // transposed scores: keys are rows (c0, c0 + 8), queries columns
    float s[2][4] = {}, dp[2][4] = {};
    scores2<D, kSplit>(Kh, Kl, Qs, 0, Vh, Vl, dOs, 0, 1, wm, 16 * wn, lane, s, dp);
    uint32_t pdh[2][4], pdl[2][4], dsh[2][4], dsl[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rq = 16 * wn + 8 * j + 2 * t + (i & 1), hh = i >> 1;
        const float pv = __expf((valid[hh] ? s[j][i] * p.scale : mval) - lse[rq]);
        float pd = pv, dpv = dp[j][i];
        if (drop) {
          const bool keep = lfs2::attn_keep(r0 + rq, c0 + 8 * hh, sbh, p.threshold);
          pd = keep ? pv * p.inv_keep : 0.0f;
          dpv = keep ? dpv * p.inv_keep : 0.0f;
        }
        split(pd, pdh[j][i], pdl[j][i]);
        split(valid[hh] ? pv * (dpv - dsum[rq]) * p.scale : 0.0f, dsh[j][i], dsl[j][i]);
      }
    if (which == 1) {
      accumulate<D>(dsh, dsl, Qs, 16 * wn, lane, acc);    // dK[c] += sum_r dS[r][c] Q[r]
    } else {
      accumulate<D>(pdh, pdl, dOs, 16 * wn, lane, acc);   // dV[c] += sum_r P_drop[r][c] dO[r]
      if constexpr (kBoth) accumulate<D>(dsh, dsl, Qs, 16 * wn, lane, dk2);
    }
    Ring<D>::release(it, n_tiles, ring, issue);
  }
  cp_async_wait<0>();
  const float one[2] = {1.0f, 1.0f};
  reduce_store<D>(acc, one, ring, (which == 1 ? p.dk : p.dv) + base, k0);
  if constexpr (kBoth) reduce_store<D>(dk2, one, ring, p.dk + base, k0);
}

template <int D> constexpr int fwd_smem() {
  return (2 * Geo<D>::kFrag + Geo<D>::kStages * 2 * Geo<D>::kTile) * 4;
}
template <int D> constexpr int dq_smem() {
  return ((Geo<D>::kSplitOwn ? 4 : 2) * Geo<D>::kFrag + Geo<D>::kStages * 2 * Geo<D>::kTile) * 4;
}
template <int D> constexpr int dkv_smem() {
  return ((Geo<D>::kSplitOwn ? 4 : 2) * Geo<D>::kFrag +
          Geo<D>::kStages * (2 * Geo<D>::kTile + 2 * BN)) * 4;
}
template <int D> constexpr bool reduce_fits() {
  return 4 * BM * Geo<D>::LDO <= Geo<D>::kStages * 2 * Geo<D>::kTile;
}
static_assert(reduce_fits<128>() && reduce_fits<256>(), "the reduction buffer reuses the ring");
static_assert(fwd_smem<256>() <= 232448 && dq_smem<256>() <= 232448 && dkv_smem<256>() <= 232448,
              "shared memory at D = 256");

// the grid (x, y, z) of each kernel's latest accepted launch: 0 the
// forward, 1 the dQ pass, 2 the dK/dV pass
int g_grid[3][3];

template <typename K>
cudaError_t run(K kernel, int which, int smem, const Params& p, int B, int blocks_x,
                cudaStream_t s) {
  cudaError_t err = lfs2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks_x, p.H, B);
  kernel<<<grid, kThreads, smem, s>>>(p);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    g_grid[which][0] = grid.x;
    g_grid[which][1] = grid.y;
    g_grid[which][2] = grid.z;
  }
  return err;
}

bool shape_ok(int B, int H, int T_len, int d) {
  return B >= 1 && H >= 1 && T_len >= BN && T_len % BN == 0 && (d == 128 || d == 256);
}

template <int D> cudaError_t fwd(const Params& p, int B, cudaStream_t s) {
  return run(fwd_kernel<D>, 0, fwd_smem<D>(), p, B, p.T / BM, s);
}
template <int D> cudaError_t bwd(const Params& p, int B, cudaStream_t s) {
  const cudaError_t err = run(dq_kernel<D>, 1, dq_smem<D>(), p, B, p.T / BM, s);
  if (err != cudaSuccess) return err;
  return run(dkv_kernel<D>, 2, dkv_smem<D>(), p, B, (Geo<D>::kBothKV ? 1 : 2) * (p.T / BM), s);
}

}  // namespace

LFS2_DEFINE_ERROR_STRING

// f32 q, k, v (B, H, T, d), d = 128 or 256; o and lse (B, H, T) f32 are
// written; seed is one int32 on the device. o32, the output in f32 (the
// bf16 route's signature), is o itself.
LFS2_EXPORT int lfs2_flash_attention_fwd(const void* q, const void* k, const void* v,
                                         const int* mask, const int* seed, void* o, float* lse,
                                         float* o32, int B, int H, int T_len, int d, float scale,
                                         unsigned threshold, float inv_keep, void* stream) {
  if (!shape_ok(B, H, T_len, d) || o32 != o) return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
           mask, seed, nullptr, nullptr, static_cast<float*>(o), lse, nullptr, nullptr, nullptr,
           H, T_len, scale, threshold, inv_keep};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(d == 128 ? fwd<128>(p, B, s) : fwd<256>(p, B, s));
}

// the dQ pass (which also writes dsum, (B, H, T) f32 scratch), then the
// K-major dK/dV pass, on one stream
LFS2_EXPORT int lfs2_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const int* mask, const int* seed, const void* o,
                                         const float* lse, const void* dout, void* dq, void* dk,
                                         void* dv, float* dsum, int B, int H, int T_len, int d,
                                         float scale, unsigned threshold, float inv_keep,
                                         void* stream) {
  if (!shape_ok(B, H, T_len, d)) return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
           mask, seed, static_cast<const float*>(o), static_cast<const float*>(dout),
           static_cast<float*>(dq), const_cast<float*>(lse), dsum, static_cast<float*>(dk),
           static_cast<float*>(dv), H, T_len, scale, threshold, inv_keep};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(d == 128 ? bwd<128>(p, B, s) : bwd<256>(p, B, s));
}

// copies into out[0..2] the grid of kernel `which` (0 the forward, 1 the dQ
// pass, 2 the dK/dV pass) as its latest launch was given it; zeros before
// the first
LFS2_EXPORT int lfs2_flash_attention_last_grid(int which, int* out) {
  if (which < 0 || which > 2) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 3; ++i) out[i] = g_grid[which][i];
  return 0;
}

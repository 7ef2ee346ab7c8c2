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
// kernels folded time into lanes (tap_blocks) and rolled an f32 product to
// fill the MXU; neither is carried over: this kernel takes the unfolded
// (B, L, C) signal and (k, C_in, C_out) tap weights.
//
// What bounds it on an H100: operations. Six convs of k taps cost
// 2*k*C*C FLOP per sample each; at C=256, k=11 that is ~8.7 MFLOP per
// sample against 4*C bytes of input and output, far above the card's 295
// FLOP per byte. Every route runs the whole chain from on-chip memory: one
// block owns a time tile plus a halo equal to the sum of the six convs'
// reaches (60 samples for k=11, d=1,3,5), each conv computes exactly the
// rows the next one needs (the valid region shrinks by the conv's reach),
// and only the tile's output is written back. The halo rows are recomputed
// by the neighbouring block; the tile plan (ops/hifigan_resblock.py
// tile_plan) weighs that share against the number of blocks.
//
// What holds the tensor-core routes back is the taps, not the signal. A
// conv's (k*C_in, C_out) taps (1.44 MB at C=256, k=11 in bf16) cannot stay
// on chip, so they stream from L2 in 16 KB K-chunks, and each chunk must
// serve as many rows as the accumulators allow before the next replaces
// it. The CUDA-core code these routes replaced re-read a tap's (C, C) slice
// for every 4 rows (about 4 FLOP per byte of L2 traffic) and ran at about
// 3 TFLOP/s at stage 0. Here a chunk serves a 128-row pass at C >= 128
// (128 FLOP a byte) and a 256-row pass below. On this card the copies,
// not L2's bandwidth, then cost the most: 1024 16-byte cp.async a chunk
// share the load pipe with the A fragments' ldmatrix. So the wgmma and
// f32 routes move each chunk with one bulk copy.
//
// Each conv is an implicit GEMM, y[r] = sum_j A_j[r] @ W_j with A_j[r] =
// in[r + j*d - p], f32 accumulators (bf16 operands, or f32 ones formed as
// split-TF32 products). A_j is a row offset into the signal, never a copy:
// ldmatrix takes one row address per lane, so any shift is free, and bf16
// rows are padded by 16 bytes so that any eight consecutive rows fall in
// distinct bank groups. The leaky on conv 1's input is applied once per A
// fragment in registers (in bf16 times 0.1f in f32, rounded once), not per
// product. The epilogue
// adds the f32 bias, zeroes rows outside [0, L), and stores leaky(y)
// rounded (conv 1) or x + round(y) rounded (conv 2).
//   wgmma route (wg_*, C = 128 and 256): two warpgroups of 64 rows by all
//     C channels, A from registers, B from a 3-stage ring of swizzled
//     chunks, one bulk copy and one mbarrier each.
//   mma.sync route (mma_*, C = 8 to 64): eight warps of 32 rows by all C
//     channels, B through ldmatrix.trans from a 2-stage cp.async ring of
//     row-padded chunks, the operands of a k-step loaded during the last.
//     At C = 8 a conv's K is k * 8, an odd number of 8-row halves of
//     mma.sync's k16: the last k-step's upper half is zeroed in A (its B
//     rows are zeros or an earlier chunk's taps, never uninitialised).
//
//   f32 route (f32_*, every C): split-TF32 mma.sync m16n8k8 (csrc/mma.cuh),
//     each f32 product as a_hi b_lo + a_lo b_hi + a_hi b_hi, which keeps
//     f32's digits (the dropped a_lo b_lo is below 2^-22 of the product).
//     A chunk's split products sum from zero on the tensor cores and are
//     added to the accumulators with f32 adds: the tensor cores' f32
//     accumulation truncates, and over the k C terms of a conv (2816 at
//     C = 256, k = 11) one accumulator drifted to about 1e-4 of the sum on
//     an H100, five times the f32 tolerance. The taps come split into hi
//     and lo halves, in fragment order, from ops/hifigan_resblock.py
//     _kernel_taps: a lane reads its two B values of both halves in one
//     16-byte load, a chunk (32 KB, 8 KB at C = 32) is one bulk copy into a
//     2-stage ring. The signal is split in registers as each A fragment is
//     loaded, two float2 loads a m16 tile (rows padded by 32 bytes): within
//     each group of 8 input channels the product's k index t is channel 2t
//     and t + 4 is 2t + 1 (the taps are laid out to match). Eight warps of 32 rows by 64 of the block's
//     output channels (32 at C = 32). An f32 row takes twice a bf16 one
//     and the split taps four times, so shared memory is the crux; the
//     plan (ops/hifigan_resblock.py tile_plan) picks the tile and where x
//     lies: in shared memory, or (XS false) in a per-block scratch slice
//     of device memory that stays in L2, which leaves shared memory to t.
//     At C = 256 a 512-frame call has 4096 rows for 132 SMs: with a block
//     a tile, the halo (60 rows a side at k = 11) would be most of the
//     work. There a cluster of 4 blocks shares a row tile (NS = 4), each
//     computing a quarter of the output channels from all input channels,
//     x and t in the tile's scratch slice, and a cluster barrier between
//     convs: tiles four times as long for the same blocks.
//
// HiFi-GAN V2's narrow stages (C = 16 and 8) take the mma.sync and f32
// routes. There a row is 16 to 64 bytes and a conv's taps a few KB: the
// work is bound by bytes (the tile plan weighs the bytes a block moves),
// and one chunk holds all of a conv's taps. The TPU kernels folded such
// stages into 128 lanes (tap_blocks), multiplying the MACs by the fold;
// these take them unfolded.
//
// Shapes the kernel takes: C in {8, 16, 32, 64, 128, 256}, up to three
// resblocks of up to three dilation pairs each, any L >= 1.
//
// Past C = 256 (ROADMAP B16w; a HiFi-GAN at upsample_initial_channel 1024
// has C = 512 at stage 0), the wide route (wide_conv: one resblock, any C a
// multiple of 128, both dtypes) runs the chain one conv a launch. There a
// 64-row f32 accumulator over all C outputs (128 KB at C = 512) fits no
// warpgroup, and a conv's taps (5.8 MB at C = 512, k = 11 in bf16) only
// stream. Each conv is an implicit GEMM over every row of the signal
// (csrc/gemm_mma.cuh: 128 rows by 128 output channels a block, the output
// channels split across blocks, the taps streamed through shared memory
// from their (C_out, k C_in) transpose): A gathers the conv's rows from
// the signal, leaky applied for the first conv of a pair, zero outside [0,
// L); the epilogue stores leaky(y + b) rounded into a scratch signal
// (first conv) or x + round(y + b) rounded into out (second conv, in place
// after the first pair). No halo is recomputed; the intermediate signals
// go through device memory instead, which at a stage's sizes stays in L2.
// Chosen over a cluster that shares the intermediate through distributed
// shared memory because a cluster's blocks would each still need all C
// channels of every halo row: the split across launches keeps one simple
// product that both dtypes and every C share.
#include "common.cuh"
#include "gemm_mma.cuh"
#include "mma.cuh"

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRes = 3;
constexpr int kMaxPairs = 3;
constexpr int kMaxConvs = kMaxRes * 2 * kMaxPairs;
constexpr int kMaxSmem = 232448;  // shared memory a block may take on sm_90

struct Spec {
  int n_res;
  int k[kMaxRes];
  int n_pairs[kMaxRes];
  int dil[kMaxRes][kMaxPairs];
  int reach[kMaxRes];                    // sum of the resblock's conv reaches
  long long w_off[kMaxRes][2 * kMaxPairs];  // element offsets of each conv's taps
  int b_off[kMaxRes][2 * kMaxPairs];        // row of each conv's bias
};

// the latest accepted launch, either route: grid x, y, z, shared-memory
// bytes a block and the time tile
int g_last_launch[5];

cudaError_t record_launch(const dim3& grid, int smem, int tile) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    g_last_launch[0] = grid.x;
    g_last_launch[1] = grid.y;
    g_last_launch[2] = grid.z;
    g_last_launch[3] = smem;
    g_last_launch[4] = tile;
  }
  return err;
}

// ======================= bf16 route: tensor cores ==========================
using bf16 = __nv_bfloat16;

constexpr int kChunkElems = 8192;  // one K-chunk of taps: 16 KB of bf16

// One conv of the chain, the same in every block: its taps, bias row,
// kernel size and dilation, and the buffer rows [olo, ohi) it computes.
struct ConvStep {
  long long w_off;
  int b_off;
  int k, d;
  int olo, ohi;
  int first;  // 1: dilated conv (reads x, writes t); 0: plain conv (reads t, adds into x)
};

struct Sched {
  int n_res;
  int n_convs;
  int res_convs[kMaxRes];  // convs of each resblock
  int res_lo[kMaxRes];     // buffer rows of x each resblock loads: [lo, hi)
  int res_hi[kMaxRes];
  int t_lo;                // buffer row of t's row 0
  int x_rows, t_rows;
  ConvStep conv[kMaxConvs];
};

// cp.async, ldmatrix and mma.sync (csrc/mma.cuh)
using lfs2::cp_async16;
using lfs2::cp_async_commit;
using lfs2::cp_async_wait_all;
using lfs2::ldmatrix_x4;
using lfs2::ldmatrix_x4_trans;
using lfs2::mma_bf16;
using lfs2::smem_u32;

// leaky on two packed bf16: max(a, bf16(a * 0.1f)), the product in f32 and
// rounded once (a bf16 0.1 is 0.10009765625, and would round differently)
__device__ __forceinline__ uint32_t leaky2(uint32_t v) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 f = __bfloat1622float2(h);
  const __nv_bfloat162 r = __hmax2(h, __floats2bfloat162_rn(f.x * 0.1f, f.y * 0.1f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The A fragment of 16 rows by 16 K-rows (mma.m16n8k16's layout, which
// wgmma takes from registers too): this lane's row is a_row, clamped to the
// buffer (a clamped row only feeds an output row past the conv's end, which
// the epilogue drops); lanes 16-31 give the upper 8 K-rows, kg + 8. K-row
// kk is tap j = kk / C, channel kk % C, and tap j shifts the row by j*d -
// pad (at C = 8 the two halves are two taps).
template <int C, int LD>
__device__ __forceinline__ void load_a(uint32_t a[4], unsigned src, int src_rows, int a_row,
                                       int kg, int d, int pad, int lane) {
  const int kk = kg + (lane >> 4) * 8;
  const int r = min(a_row + (kk / C) * d - pad, src_rows - 1);
  ldmatrix_x4(a, src + 2u * (r * LD + kk % C));
}

// Two 8 x 8 b16 matrices, transposed: lanes 0-15 give the row addresses
// (one n8 tile of B at C = 8)
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t r[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void leaky_a(uint32_t a[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = leaky2(a[i]);
}

// ---- the chain around the products, shared by both routes ----------------
// The chunk stream: the (conv, pass, chunk) whose taps are loaded next.
struct Cursor {
  int conv, pass, chunk;
};

template <int C, int KC, int PASS>
__device__ __forceinline__ void advance(Cursor& c, const Sched& sc) {
  const ConvStep& cs = sc.conv[c.conv];
  if (++c.chunk * KC >= cs.k * C) {
    c.chunk = 0;
    if (++c.pass * PASS >= cs.ohi - cs.olo) {
      c.pass = 0;
      ++c.conv;
    }
  }
}

// The input rows [lo, hi) of a resblock into x, zero outside [0, L)
template <int C, int LD>
__device__ __forceinline__ void load_x(bf16* xs, const bf16* __restrict__ xb, int lo, int hi,
                                       int g0, int L) {
  constexpr int kVec = C / 8;
  for (int idx = threadIdx.x; idx < (hi - lo) * kVec; idx += kThreads) {
    const int row = lo + idx / kVec, v = idx % kVec;
    const int gp = g0 + row;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gp >= 0 && gp < L)
      val = *reinterpret_cast<const uint4*>(xb + static_cast<long long>(gp) * C + v * 8);
    *reinterpret_cast<uint4*>(xs + row * LD + v * 8) = val;
  }
}

// The epilogue of two adjacent channels of one output row: y = acc + bias,
// zero outside [0, L); conv 1 stores leaky(y) into t, conv 2 x += round(y)
template <int LD>
__device__ __forceinline__ void store_pair(const ConvStep& cs, bf16* xs, bf16* ts, int t_lo,
                                           int row, int col, float a0, float a1, float2 bv,
                                           bool inside) {
  const float v0 = inside ? a0 + bv.x : 0.0f;
  const float v1 = inside ? a1 + bv.y : 0.0f;
  if (cs.first) {
    *reinterpret_cast<__nv_bfloat162*>(ts + (row - t_lo) * LD + col) =
        __floats2bfloat162_rn(fmaxf(v0, v0 * 0.1f), fmaxf(v1, v1 * 0.1f));
  } else {
    __nv_bfloat162* xp = reinterpret_cast<__nv_bfloat162*>(xs + row * LD + col);
    const float2 xv = __bfloat1622float2(*xp);
    const float2 yv = __bfloat1622float2(__floats2bfloat162_rn(v0, v1));
    *xp = __floats2bfloat162_rn(xv.x + yv.x, xv.y + yv.y);
  }
}

// The tile's rows of resblock r into the output: x1, then ((x1 + x2) + x3) / 3
template <int C, int LD>
__device__ __forceinline__ void combine(const bf16* xs, bf16* __restrict__ ob, int halo, int t0,
                                        int tile, int L, int r, int n_res) {
  constexpr int kVec = C / 8;
  for (int idx = threadIdx.x; idx < tile * kVec; idx += kThreads) {
    const int i = idx / kVec, v = idx % kVec;
    const int gp = t0 + i;
    if (gp >= L) break;
    uint4* op = reinterpret_cast<uint4*>(ob + static_cast<long long>(gp) * C + v * 8);
    const uint4 xv = *reinterpret_cast<const uint4*>(xs + (halo + i) * LD + v * 8);
    if (r == 0) {
      *op = xv;
      continue;
    }
    uint4 ov = *op;
    const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&xv);
    __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&ov);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 a = __bfloat1622float2(oh[j]), c = __bfloat1622float2(xh[j]);
      float s0 = lfs2::round_to<bf16>(a.x + c.x), s1 = lfs2::round_to<bf16>(a.y + c.y);
      if (r == n_res - 1) {
        s0 = s0 / static_cast<float>(n_res);
        s1 = s1 / static_cast<float>(n_res);
      }
      oh[j] = __floats2bfloat162_rn(s0, s1);
    }
    *op = ov;
  }
}

// ---- C <= 64: mma.sync ------------------------------------------------------
// A warp owns 32 rows by all C channels (NT n8 tiles); the 8 warps span a
// 256-row pass. Taps stream through a 2-stage ring of row-padded chunks
// read with ldmatrix.trans. Below C = 32 a chunk holds 256 K-rows, a whole
// conv's taps up to k = 16 (C = 16) or 32 (C = 8), and C = 8 pads its rows
// to 48 bytes: eight rows 32 bytes apart would meet in two bank groups.
template <int C> struct MmaGeo {
  static constexpr int MT = 2;                // m16 tiles per warp
  static constexpr int NT = C / 8;            // n8 tiles per warp
  static constexpr int NB = (NT + 1) / 2;     // B loads per k-step (two n8 tiles each)
  static constexpr int PASS = 16 * MT * 8;    // rows per pass
  static constexpr int KC = kChunkElems / C < 256 ? kChunkElems / C : 256;  // K rows per chunk
  static constexpr int LD = C == 8 ? 24 : C + 8;  // padded row stride (elements)
  static constexpr int STAGES = 2;
};

// K rows [k0, k0 + rows) of one conv's (k*C, C) taps into a padded stage
template <int C>
__device__ __forceinline__ void issue_chunk_padded(const bf16* __restrict__ taps, int k0,
                                                   int rows, unsigned dst) {
  using G = MmaGeo<C>;
  constexpr int kVec = C / 8;  // 16-byte pieces per row
  const bf16* src = taps + static_cast<long long>(k0) * C;
  for (int idx = threadIdx.x; idx < rows * kVec; idx += kThreads) {
    const int r = idx / kVec, v = idx % kVec;
    cp_async16(dst + 2u * (r * G::LD + v * 8), src + static_cast<long long>(r) * C + v * 8);
  }
}

// The operands of one k-step of 16: the warp's A rows and its B columns
template <int C> struct Frags {
  uint32_t a[MmaGeo<C>::MT][4];
  uint32_t b[MmaGeo<C>::NB][4];
};

// the operands of k-step s of a chunk of krem K-rows; a k-step with only
// 8 of them left (C = 8) zeroes A's upper half
template <int C>
__device__ __forceinline__ void load_frags(Frags<C>& f, unsigned src, int src_rows, int a_row,
                                           unsigned b_addr, int kg0, int s, int krem, int d,
                                           int pad, int n_mt, int lane) {
  using G = MmaGeo<C>;
  const bool half = C % 16 != 0 && 16 * s + 8 == krem;
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
    if (mt < n_mt) {
      load_a<C, G::LD>(f.a[mt], src, src_rows, a_row + 16 * mt, kg0 + 16 * s, d, pad, lane);
      if (half) f.a[mt][2] = f.a[mt][3] = 0u;
    }
#pragma unroll
  for (int np = 0; np < G::NB; ++np) {
    if constexpr (G::NT == 1)
      ldmatrix_x2_trans(f.b[np], b_addr + 2u * (16 * s * G::LD));
    else
      ldmatrix_x4_trans(f.b[np], b_addr + 2u * (16 * s * G::LD + np * 16));
  }
}

// the step's products, with the leaky on conv 1's input applied to A here,
// a step after its load
template <int C, bool FIRST>
__device__ __forceinline__ void frag_products(float (&acc)[MmaGeo<C>::MT][MmaGeo<C>::NT][4],
                                              Frags<C>& f, int n_mt) {
  using G = MmaGeo<C>;
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt) {
    if (mt >= n_mt) continue;
    if (FIRST) leaky_a(f.a[mt]);
#pragma unroll
    for (int np = 0; np < G::NB; ++np) {
      mma_bf16(acc[mt][2 * np], f.a[mt], f.b[np]);
      if (2 * np + 1 < G::NT) mma_bf16(acc[mt][2 * np + 1], f.a[mt], f.b[np] + 2);
    }
  }
}

// acc += the products of one K-chunk of krem K-rows (k-steps of 16, the
// last one half at C = 8) for the warp's rows, the operands of step s + 1
// loaded while step s's products issue
template <int C, bool FIRST>
__device__ __forceinline__ void mma_chunk(float (&acc)[MmaGeo<C>::MT][MmaGeo<C>::NT][4],
                                          unsigned src, int src_rows, int a_row, unsigned stage,
                                          int kg0, int krem, int d, int pad, int n_mt,
                                          int lane) {
  using G = MmaGeo<C>;
  const unsigned b_addr =
      stage + 2u * (((lane & 7) + ((lane >> 3) & 1) * 8) * G::LD + (lane >> 4) * 8);
  const int ksteps = (krem + 15) / 16;
  Frags<C> f0, f1;
  load_frags<C>(f0, src, src_rows, a_row, b_addr, kg0, 0, krem, d, pad, n_mt, lane);
  for (int s = 0; s < ksteps; s += 2) {
    if (s + 1 < ksteps)
      load_frags<C>(f1, src, src_rows, a_row, b_addr, kg0, s + 1, krem, d, pad, n_mt, lane);
    frag_products<C, FIRST>(acc, f0, n_mt);
    if (s + 1 < ksteps) {
      if (s + 2 < ksteps)
        load_frags<C>(f0, src, src_rows, a_row, b_addr, kg0, s + 2, krem, d, pad, n_mt, lane);
      frag_products<C, FIRST>(acc, f1, n_mt);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
mma_resblock_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                    const bf16* __restrict__ w, const float* __restrict__ bias, int L, int tile,
                    int halo, const __grid_constant__ Sched sc) {
  using G = MmaGeo<C>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const unsigned ring = smem_u32(smem_raw);
  bf16* xs = reinterpret_cast<bf16*>(smem_raw) + G::STAGES * G::KC * G::LD;
  bf16* ts = xs + sc.x_rows * G::LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int t0 = blockIdx.x * tile;
  const int g0 = t0 - halo;  // signal position of buffer row 0
  const bf16* xb = x + static_cast<long long>(blockIdx.y) * L * C;
  bf16* ob = out + static_cast<long long>(blockIdx.y) * L * C;
  constexpr int kStageBytes = G::KC * G::LD * 2;
  if constexpr (C % 16 != 0) {
    // a half k-step reads 8 B rows past its chunk: zeros, or taps of an
    // earlier chunk, multiplied by A's zeroed half
    for (int i = threadIdx.x; i < G::STAGES * kStageBytes / 16; i += kThreads)
      reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }

  // the next chunk is issued before this one's products, into the other stage
  Cursor cur = {0, 0, 0};
  issue_chunk_padded<C>(w + sc.conv[0].w_off, 0, min(G::KC, sc.conv[0].k * C), ring);
  cp_async_commit();
  advance<C, G::KC, G::PASS>(cur, sc);
  int q = 0, ci = 0;
  for (int r = 0; r < sc.n_res; ++r) {
    load_x<C, G::LD>(xs, xb, sc.res_lo[r], sc.res_hi[r], g0, L);
    // (the first chunk barrier below orders these stores before any read)
    for (int e = 0; e < sc.res_convs[r]; ++e, ++ci) {
      const ConvStep cs = sc.conv[ci];
      const int K = cs.k * C;
      const int chunks = (K + G::KC - 1) / G::KC;
      const int passes = (cs.ohi - cs.olo + G::PASS - 1) / G::PASS;
      const int pad = cs.d * (cs.k - 1) / 2;
      const float* bconv = bias + static_cast<long long>(cs.b_off) * C;
      const unsigned src = smem_u32(cs.first ? xs : ts);
      const int src_base = cs.first ? 0 : sc.t_lo;
      const int src_rows = cs.first ? sc.x_rows : sc.t_rows;
      for (int p = 0; p < passes; ++p) {
        const int row0 = cs.olo + p * G::PASS + warp * 16 * G::MT;
        const int n_mt = max(0, min(G::MT, (cs.ohi - row0 + 15) / 16));
        float acc[G::MT][G::NT][4];
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
        for (int i = 0; i < chunks; ++i, ++q) {
          cp_async_wait_all();
          __syncthreads();  // chunk q has landed for every thread; q - 1's stage is free
          if (cur.conv < sc.n_convs) {
            const ConvStep& nx = sc.conv[cur.conv];
            issue_chunk_padded<C>(w + nx.w_off, cur.chunk * G::KC,
                                  min(G::KC, nx.k * C - cur.chunk * G::KC),
                                  ring + ((q + 1) % G::STAGES) * kStageBytes);
            advance<C, G::KC, G::PASS>(cur, sc);
          }
          cp_async_commit();
          if (n_mt == 0) continue;
          const int krem = min(G::KC, K - i * G::KC);
          const unsigned stage = ring + (q % G::STAGES) * kStageBytes;
          const int a_row = row0 + (lane & 15) - src_base;
          if (cs.first)
            mma_chunk<C, true>(acc, src, src_rows, a_row, stage, i * G::KC, krem, cs.d, pad,
                               n_mt, lane);
          else
            mma_chunk<C, false>(acc, src, src_rows, a_row, stage, i * G::KC, krem, cs.d, pad,
                                n_mt, lane);
        }
#pragma unroll
        for (int nt = 0; nt < G::NT; ++nt) {
          const int col = nt * 8 + 2 * tq;
          const float2 bv = *reinterpret_cast<const float2*>(bconv + col);
#pragma unroll
          for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = row0 + 16 * mt + g + 8 * h;
              if (mt < n_mt && row < cs.ohi)
                store_pair<G::LD>(cs, xs, ts, sc.t_lo, row, col, acc[mt][nt][2 * h],
                                  acc[mt][nt][2 * h + 1], bv, g0 + row >= 0 && g0 + row < L);
            }
        }
      }
    }
    __syncthreads();
    combine<C, G::LD>(xs, ob, halo, t0, tile, L, r, sc.n_res);
    __syncthreads();
  }
}

// ---- C >= 128: wgmma --------------------------------------------------------
// Two warpgroups, each 64 rows by all C channels (m64nCk16), span a
// 128-row pass. A comes from registers (ldmatrix at any row shift, the
// leaky applied there), B from shared memory in the MN-major layout with
// 128-byte swizzle (csrc/flash_attention_sm90.cu's V tiles): 64-channel
// boxes of 128-byte rows, 16-byte pieces XOR-swizzled by row % 8. The
// taps are stored in that layout, chunk by chunk (ops/hifigan_resblock.py
// prepare_resblock_weights), so one thread moves a 16 KB chunk with one
// bulk copy, off the load pipe the A fragments take. A 3-stage ring,
// filled two chunks ahead, an mbarrier per stage.
template <int C> struct WgGeo {
  static constexpr int PASS = 128;             // rows per pass
  static constexpr int KC = kChunkElems / C;   // K rows per chunk
  static constexpr int KS = KC / 16;           // k-steps per chunk
  static constexpr int LD = C + 8;             // x and t row stride (elements)
  static constexpr int BOX = KC * 128;         // bytes of one 64-channel box of a chunk
  static constexpr int STAGE = KC * C * 2;     // bytes of a chunk
  static constexpr int STAGES = 3;
  static constexpr int BARS = 64;              // bytes for the stages' mbarriers
  static_assert(C % 128 == 0 && C <= 256 && BOX % 1024 == 0, "wgmma geometry");
};

// descriptor high word: stride of 8-row groups along K (1024 bytes) and
// the 128-byte swizzle; the low word holds the start address >> 4 and the
// leading offset, the stride from one 64-channel box to the next
constexpr uint32_t kDescHi = (1024u >> 4) | (1u << 30);

template <int BOX> __device__ __forceinline__ uint32_t desc_lo(uint32_t addr) {
  return ((addr & 0x3FFFFu) >> 4) | ((BOX >> 4) << 16);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Registers an in-flight wgmma reads or writes, pinned after the wait that
// retires it, so that the compiler neither reuses nor reads them before
template <int N> __device__ __forceinline__ void hold(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N> __device__ __forceinline__ void hold(uint32_t (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

// d (64 x N) += A (registers) * B (smem, MN-major: the transpose bit), B's
// 64-channel boxes apart by the descriptor's leading offset
template <int N>
__device__ __forceinline__ void wgmma_rs_t(float (&d)[N / 2], const uint32_t (&a)[4], uint32_t db);

template <> __device__ __forceinline__ void wgmma_rs_t<128>(float (&d)[64], const uint32_t (&a)[4],
                                                          uint32_t db) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\nsetp.ne.b32 p, %70, 0;\n"
      "mov.b64 db, {%68, %69};\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(db), "r"(kDescHi), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs_t<256>(float (&d)[128], const uint32_t (&a)[4],
                                                          uint32_t db) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\nsetp.ne.b32 p, %134, 0;\n"
      "mov.b64 db, {%132, %133};\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(db), "r"(kDescHi), "r"(1));
}

// mbarriers and bulk copies (csrc/mma.cuh)
using lfs2::bulk_load;
using lfs2::mbar_expect_tx;
using lfs2::mbar_init;
using lfs2::mbar_wait;

// acc += one K-chunk's products for the warpgroup's 64 rows. The next
// chunk's copies (issue_next) are issued once the products are in flight:
// ahead of them they would queue before the A loads in the load pipe.
template <int C, bool FIRST, typename Issue>
__device__ __forceinline__ void wg_chunk(float (&acc)[C / 2], unsigned src, int src_rows,
                                         int a_row, unsigned stage, int kg0, int d, int pad,
                                         int lane, Issue&& issue_next) {
  using G = WgGeo<C>;
  uint32_t a[G::KS][4];
#pragma unroll
  for (int s = 0; s < G::KS; ++s)
    load_a<C, G::LD>(a[s], src, src_rows, a_row, kg0 + 16 * s, d, pad, lane);
  if (FIRST) {
#pragma unroll
    for (int s = 0; s < G::KS; ++s) leaky_a(a[s]);
  }
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < G::KS; ++s)
    wgmma_rs_t<C>(acc, a[s], desc_lo<G::BOX>(stage + s * 16 * 128));
  wgmma_commit();
  issue_next();
  wgmma_wait_all();
  hold(acc);
  hold(a);
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
wg_resblock_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                   const bf16* __restrict__ w, const float* __restrict__ bias, int L, int tile,
                   int halo, const __grid_constant__ Sched sc) {
  using G = WgGeo<C>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const unsigned ring = smem_u32(smem);
  const unsigned full = ring + G::STAGES * G::STAGE;  // a stage's chunk has landed
  bf16* xs = reinterpret_cast<bf16*>(smem + G::STAGES * G::STAGE + G::BARS);
  bf16* ts = xs + sc.x_rows * G::LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wq = warp & 3;   // warpgroup, warp within it
  const int g = lane >> 2, tq = lane & 3;
  const int t0 = blockIdx.x * tile;
  const int g0 = t0 - halo;  // signal position of buffer row 0
  const bf16* xb = x + static_cast<long long>(blockIdx.y) * L * C;
  bf16* ob = out + static_cast<long long>(blockIdx.y) * L * C;

  // chunks are issued two ahead of the one whose products run, by thread 0
  Cursor cur = {0, 0, 0};
  auto issue = [&](int stage) {
    if (cur.conv >= sc.n_convs) return;
    if (threadIdx.x == 0) {
      mbar_expect_tx(full + 8 * stage, G::STAGE);
      bulk_load(ring + stage * G::STAGE,
                w + sc.conv[cur.conv].w_off + static_cast<long long>(cur.chunk) * G::KC * C,
                G::STAGE, full + 8 * stage);
    }
    __syncwarp();  // warp 0 whole again before its next wgmma instruction
    advance<C, G::KC, G::PASS>(cur, sc);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < G::STAGES; ++i) mbar_init(full + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int i = 0; i < G::STAGES - 1; ++i) issue(i);
  int q = 0, ci = 0;
  for (int r = 0; r < sc.n_res; ++r) {
    load_x<C, G::LD>(xs, xb, sc.res_lo[r], sc.res_hi[r], g0, L);
    // (the first chunk barrier below orders these stores before any read)
    for (int e = 0; e < sc.res_convs[r]; ++e, ++ci) {
      const ConvStep cs = sc.conv[ci];
      const int chunks = cs.k * C / G::KC;
      const int passes = (cs.ohi - cs.olo + G::PASS - 1) / G::PASS;
      const int pad = cs.d * (cs.k - 1) / 2;
      const float* bconv = bias + static_cast<long long>(cs.b_off) * C;
      const unsigned src = smem_u32(cs.first ? xs : ts);
      const int src_base = cs.first ? 0 : sc.t_lo;
      const int src_rows = cs.first ? sc.x_rows : sc.t_rows;
      for (int p = 0; p < passes; ++p) {
        const int row0 = cs.olo + p * G::PASS + wg * 64;  // the warpgroup's first row
        const bool active = row0 < cs.ohi;
        float acc[C / 2];
#pragma unroll
        for (int i = 0; i < C / 2; ++i) acc[i] = 0.0f;
        for (int i = 0; i < chunks; ++i, ++q) {
          mbar_wait(full + 8 * (q % G::STAGES), (q / G::STAGES) & 1);  // chunk q has landed
          __syncthreads();  // every warpgroup is done with chunk q - 1's stage
          auto issue_next = [&] { issue((q + G::STAGES - 1) % G::STAGES); };
          const unsigned stage = ring + (q % G::STAGES) * G::STAGE;
          const int a_row = row0 + 16 * wq + (lane & 15) - src_base;
          if (!active)
            issue_next();
          else if (cs.first)
            wg_chunk<C, true>(acc, src, src_rows, a_row, stage, i * G::KC, cs.d, pad, lane,
                              issue_next);
          else
            wg_chunk<C, false>(acc, src, src_rows, a_row, stage, i * G::KC, cs.d, pad, lane,
                               issue_next);
        }
        if (!active) continue;
        // accumulator layout: n8 block j holds rows g and g + 8 of the
        // warp's 16, channels 8j + 2tq and + 1
#pragma unroll
        for (int j = 0; j < C / 8; ++j) {
          const int col = 8 * j + 2 * tq;
          const float2 bv = *reinterpret_cast<const float2*>(bconv + col);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + 16 * wq + g + 8 * h;
            if (row < cs.ohi)
              store_pair<G::LD>(cs, xs, ts, sc.t_lo, row, col, acc[4 * j + 2 * h],
                                acc[4 * j + 2 * h + 1], bv, g0 + row >= 0 && g0 + row < L);
          }
        }
      }
    }
    __syncthreads();
    combine<C, G::LD>(xs, ob, halo, t0, tile, L, r, sc.n_res);
    __syncthreads();
  }
}

// shared-memory bytes of the bf16 launch: the tap ring (plus the 1 KB that
// aligns the swizzled one and its mbarriers), x and t
int bf16_smem_bytes(int C, const Sched& sc) {
  const int rows = sc.x_rows + sc.t_rows;
  switch (C) {
    case 8: return (MmaGeo<8>::STAGES * MmaGeo<8>::KC + rows) * MmaGeo<8>::LD * 2;
    case 16: return (MmaGeo<16>::STAGES * MmaGeo<16>::KC + rows) * MmaGeo<16>::LD * 2;
    case 32: return (MmaGeo<32>::STAGES * MmaGeo<32>::KC + rows) * MmaGeo<32>::LD * 2;
    case 64: return (MmaGeo<64>::STAGES * MmaGeo<64>::KC + rows) * MmaGeo<64>::LD * 2;
    case 128: return 1024 + WgGeo<128>::STAGES * WgGeo<128>::STAGE + WgGeo<128>::BARS +
                     rows * WgGeo<128>::LD * 2;
    case 256: return 1024 + WgGeo<256>::STAGES * WgGeo<256>::STAGE + WgGeo<256>::BARS +
                     rows * WgGeo<256>::LD * 2;
    default: return -1;
  }
}

template <typename K>
cudaError_t bf16_launch(K kernel, int smem, const void* x, void* out, const void* w,
                        const float* bias, int B, int L, int tile, int halo, const Sched& sc,
                        cudaStream_t stream) {
  if (smem < 0 || smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = lfs2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + tile - 1) / tile, B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const bf16*>(x), static_cast<bf16*>(out),
                                           static_cast<const bf16*>(w), bias, L, tile, halo, sc);
  return record_launch(grid, smem, tile);
}

cudaError_t bf16_dispatch(int C, const void* x, void* out, const void* w, const float* bias,
                          int B, int L, int tile, int halo, const Sched& sc, cudaStream_t s) {
  const int smem = bf16_smem_bytes(C, sc);
  switch (C) {
    case 8: return bf16_launch(mma_resblock_kernel<8>, smem, x, out, w, bias, B, L, tile, halo, sc, s);
    case 16: return bf16_launch(mma_resblock_kernel<16>, smem, x, out, w, bias, B, L, tile, halo, sc, s);
    case 32: return bf16_launch(mma_resblock_kernel<32>, smem, x, out, w, bias, B, L, tile, halo, sc, s);
    case 64: return bf16_launch(mma_resblock_kernel<64>, smem, x, out, w, bias, B, L, tile, halo, sc, s);
    case 128: return bf16_launch(wg_resblock_kernel<128>, smem, x, out, w, bias, B, L, tile, halo, sc, s);
    case 256: return bf16_launch(wg_resblock_kernel<256>, smem, x, out, w, bias, B, L, tile, halo, sc, s);
    default: return cudaErrorInvalidValue;
  }
}

// ===================== f32 route: split TF32 on the tensor cores ===========
// Eight warps, WN across the block's channels by 8 / WN down the rows;
// each owns 32 rows (MT m16 tiles) by 64 channels (NT n8 tiles; C at C <=
// 32): 64 f32 accumulators a thread (fewer below C = 64) and as many for
// the chunk's products on the tensor cores. A chunk is KC K-rows of hi and
// lo taps in fragment order. From C = 32 KC divides C, so a conv's taps
// are k * C / KC whole chunks; below, a chunk of 192 K-rows holds a whole
// conv's taps up to k = 12 (C = 16) or 24 (C = 8), and a shorter conv's
// chunk is copied and multiplied as far as its taps go.
template <int C, int NS> struct F32Geo {
  static constexpr int CN = C / NS;                  // output channels a block
  static constexpr int MT = 2;                       // m16 tiles a warp
  static constexpr int WN = CN < 64 ? 1 : CN / 64;   // warps across the channels
  static constexpr int NT = CN / 8 / WN;             // n8 tiles a warp
  static constexpr int PASS = 16 * MT * (kThreads / 32 / WN);  // rows a pass
  static constexpr int KC = C <= 16 ? 192 : C < 4096 / CN ? C : 4096 / CN;  // K rows a chunk
  static constexpr int KS = KC / 8;                  // k-steps a chunk
  static constexpr int STAGE = KC * CN * 8;          // bytes of a chunk (hi and lo)
  static constexpr int STAGES = 2;
  static constexpr int BARS = 16;                    // bytes for the stages' mbarriers
  static constexpr int LD = C + 8;                   // x and t row stride in shared memory
  static_assert((C <= 16 || C % KC == 0) && KC % 8 == 0 && STAGE <= 32768, "f32 geometry");
};

// The raw A values of one k-step for the warp's m16 tiles: rows g and
// g + 8 of each tile (a_row is this lane's row g of tile 0, in the
// source's rows, clamped to the buffer: a clamped row only feeds an output
// row past the conv's end, which the epilogue drops), input channels
// 2 tq and 2 tq + 1 of the k-step's group of 8 (k indices tq and tq + 4).
// Every tile is loaded and multiplied, also past the conv's last row: a
// guard per tile would split the products into branches that the
// compiler cannot interleave.
template <int C, int NS, int LDS>
__device__ __forceinline__ void f32_load_a(float2 (&a)[F32Geo<C, NS>::MT][2], const float* src,
                                           int src_rows, int a_row, int kg, int d, int pad,
                                           int tq) {
  const int r = a_row + (kg / C) * d - pad;
  const int c = kg % C + 2 * tq;
#pragma unroll
  for (int mt = 0; mt < F32Geo<C, NS>::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = min(r + 16 * mt + 8 * h, src_rows - 1);
      a[mt][h] = *reinterpret_cast<const float2*>(src + static_cast<long long>(rr) * LDS + c);
    }
}

// acc += one chunk's split products for the warp's rows and channels (its
// KS k-steps; below C = 32 those up to the conv's K). a holds the raw A
// values of the chunk's first k-step and leaves with the next chunk's:
// each k-step loads the next one's before its products.
// FIRST applies leaky(0.1) to A (conv 1's input) before the split. The
// chunk's products sum on the tensor cores from zero, in tc, and are
// added to acc with f32 adds: a k-step's three products are each issued
// for all MT x NT tiles before the next.
template <int C, int NS, int LDS, bool FIRST>
__device__ __forceinline__ void f32_chunk(float (&acc)[F32Geo<C, NS>::MT][F32Geo<C, NS>::NT][4],
                                          float2 (&a)[F32Geo<C, NS>::MT][2], const float* src,
                                          int src_rows, int a_row, const float4* stage, int kg0,
                                          int K, int d, int pad, int nt0, int lane) {
  using G = F32Geo<C, NS>;
  float tc[G::MT][G::NT][4];
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) tc[mt][nt][i] = 0.0f;
  const int ks = C <= 16 ? min(G::KC, K - kg0) / 8 : G::KS;
  // (unrolled further, the k-steps' loads are hoisted until registers spill)
#pragma unroll 4
  for (int s = 0; s < ks; ++s) {
    uint32_t ah[G::MT][4], al[G::MT][4];
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
      // (g, tq), (g + 8, tq), (g, tq + 4), (g + 8, tq + 4): mma_tf32's a
      float v[4] = {a[mt][0].x, a[mt][1].x, a[mt][0].y, a[mt][1].y};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (FIRST) v[i] = fmaxf(v[i], v[i] * 0.1f);
        lfs2::split(v[i], ah[mt][i], al[mt][i]);
      }
    }
    const int kn = kg0 + 8 * (s + 1);
    if (kn < K) f32_load_a<C, NS, LDS>(a, src, src_rows, a_row, kn, d, pad, lane & 3);
    // this lane's B of n8 tile nt: hi of k rows tq and tq + 4, then lo
    const float4* bp = stage + (s * (G::CN / 8) + nt0) * 32 + lane;
    uint32_t bh[G::NT][2], bl[G::NT][2];
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt) {
      const float4 b = bp[nt * 32];
      bh[nt][0] = __float_as_uint(b.x);
      bh[nt][1] = __float_as_uint(b.y);
      bl[nt][0] = __float_as_uint(b.z);
      bl[nt][1] = __float_as_uint(b.w);
    }
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) lfs2::mma_tf32(tc[mt][nt], ah[mt], bl[nt]);
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) lfs2::mma_tf32(tc[mt][nt], al[mt], bh[nt]);
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) lfs2::mma_tf32(tc[mt][nt], ah[mt], bh[nt]);
  }
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] += tc[mt][nt][i];
}

// Channels [c0, c0 + CN) of the input rows [lo, hi) of a resblock into x
// (row stride LDX), zero outside [0, L)
template <int C, int CN, int LDX>
__device__ __forceinline__ void f32_load_x(float* xs, const float* __restrict__ xb, int lo, int hi,
                                           int g0, int L, int c0) {
  constexpr int kVec = CN / 4;
  for (int idx = threadIdx.x; idx < (hi - lo) * kVec; idx += kThreads) {
    const int row = lo + idx / kVec, v = c0 / 4 + idx % kVec;
    const int gp = g0 + row;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (gp >= 0 && gp < L)
      val = *reinterpret_cast<const float4*>(xb + static_cast<long long>(gp) * C + v * 4);
    *reinterpret_cast<float4*>(xs + static_cast<long long>(row) * LDX + v * 4) = val;
  }
}

// Channels [c0, c0 + CN) of the tile's rows of resblock r into the output:
// x1, then ((x1 + x2) + x3) / 3
template <int C, int CN, int LDX>
__device__ __forceinline__ void f32_combine(const float* xs, float* __restrict__ ob, int halo,
                                            int t0, int tile, int L, int r, int n_res, int c0) {
  constexpr int kVec = CN / 4;
  for (int idx = threadIdx.x; idx < tile * kVec; idx += kThreads) {
    const int i = idx / kVec, v = c0 / 4 + idx % kVec;
    const int gp = t0 + i;
    if (gp >= L) break;
    float4* op = reinterpret_cast<float4*>(ob + static_cast<long long>(gp) * C + v * 4);
    const float4 xv =
        *reinterpret_cast<const float4*>(xs + static_cast<long long>(halo + i) * LDX + v * 4);
    if (r == 0) {
      *op = xv;
      continue;
    }
    float4 o = *op;
    o = make_float4(o.x + xv.x, o.y + xv.y, o.z + xv.z, o.w + xv.w);
    if (r == n_res - 1) {
      const float n = static_cast<float>(n_res);
      o = make_float4(o.x / n, o.y / n, o.z / n, o.w / n);
    }
    *op = o;
  }
}

// every thread of every block of the cluster; orders the blocks' device
// memory writes before the reads after it (release, acquire)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// NS == 1: one block a row tile, t in shared memory, x there too (XS) or
// in the block's slice of scratch (x_rows * C floats, row stride C), which
// stays in L2. NS > 1: a cluster of NS blocks shares a row tile, block
// `rank` computing output channels [rank C / NS, (rank + 1) C / NS) of
// every conv from all C input channels; x and t lie in the tile's slice of
// scratch ((x_rows + t_rows) * C floats), and a cluster barrier before
// each conv orders one conv's writes before the next one's reads. The tap
// ring has two chunks, one in flight while the other is read (deeper rings
// timed no faster on an H100: scripts/bench_resblock.py --sweep).
template <int C, bool XS, int NS>
__global__ void __launch_bounds__(kThreads, 1)
f32_resblock_kernel(const float* __restrict__ x, float* __restrict__ out,
                    const float* __restrict__ w, const float* __restrict__ bias, float* scratch,
                    int L, int tile, int halo, const __grid_constant__ Sched sc) {
  constexpr int stages = F32Geo<C, NS>::STAGES;
  using G = F32Geo<C, NS>;
  static_assert(NS == 1 || !XS, "a split tile keeps x in scratch");
  constexpr bool TS = NS == 1;  // t in shared memory
  constexpr int LDX = XS ? G::LD : C;
  constexpr int LDT = TS ? G::LD : C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const unsigned ring = smem_u32(smem_raw);
  const unsigned full = ring + stages * G::STAGE;  // a stage's chunk has landed
  float* sm = reinterpret_cast<float*>(smem_raw + stages * G::STAGE + G::BARS);
  const int rank = blockIdx.x % NS, tile_idx = blockIdx.x / NS;
  const long long slot = static_cast<long long>(blockIdx.y) * (gridDim.x / NS) + tile_idx;
  float* slice = scratch + slot * ((XS ? 0 : sc.x_rows) + (TS ? 0 : sc.t_rows)) * C;
  float* ts = TS ? sm : slice + (XS ? 0 : sc.x_rows * C);
  float* xs = XS ? sm + sc.t_rows * G::LD : slice;
  const int c0 = rank * G::CN;  // the block's first output channel
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp / G::WN, nt0 = (warp % G::WN) * G::NT;  // row group, first n8 tile
  const int g = lane >> 2, tq = lane & 3;
  const int t0 = tile_idx * tile;
  const int g0 = t0 - halo;  // signal position of buffer row 0
  const float* xb = x + static_cast<long long>(blockIdx.y) * L * C;
  float* ob = out + static_cast<long long>(blockIdx.y) * L * C;

  // chunk q + 1 is issued by thread 0 once every warp is done with chunk
  // q - 1's stage. The split taps take 2 floats an element
  // (w_off counts elements of the unsplit taps); a conv's taps hold the
  // blocks' output channels one block after the other.
  Cursor cur = {0, 0, 0};
  auto issue = [&](int stage) {
    if (cur.conv >= sc.n_convs) return;
    if (threadIdx.x == 0) {
      const ConvStep& cs = sc.conv[cur.conv];
      const unsigned bytes = min(G::KC, cs.k * C - cur.chunk * G::KC) * G::CN * 8;
      mbar_expect_tx(full + 8 * stage, bytes);
      bulk_load(ring + stage * G::STAGE,
                w + 2 * (cs.w_off + static_cast<long long>(rank) * cs.k * C * G::CN +
                         static_cast<long long>(cur.chunk) * G::KC * G::CN),
                bytes, full + 8 * stage);
    }
    advance<C, G::KC, G::PASS>(cur, sc);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) mbar_init(full + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int i = 0; i < stages - 1; ++i) issue(i);
  int q = 0, ci = 0;
  for (int r = 0; r < sc.n_res; ++r) {
    f32_load_x<C, G::CN, LDX>(xs, xb, sc.res_lo[r], sc.res_hi[r], g0, L, c0);
    // (NS == 1: the first chunk barrier below orders these stores before
    // any read)
    for (int e = 0; e < sc.res_convs[r]; ++e, ++ci) {
      if (NS > 1) cluster_sync();
      const ConvStep cs = sc.conv[ci];
      const int K = cs.k * C;
      const int chunks = (K + G::KC - 1) / G::KC;
      const int passes = (cs.ohi - cs.olo + G::PASS - 1) / G::PASS;
      const int pad = cs.d * (cs.k - 1) / 2;
      const float* bconv = bias + static_cast<long long>(cs.b_off) * C;
      // x or t by name in each branch below, so that the compiler knows
      // which memory each load reads
      const int src_rows = cs.first ? sc.x_rows : sc.t_rows;
      const int a_row = cs.first ? 0 : -sc.t_lo;  // buffer row -> source row
      for (int p = 0; p < passes; ++p) {
        const int row0 = cs.olo + p * G::PASS + rg * 16 * G::MT;
        const int n_mt = max(0, min(G::MT, (cs.ohi - row0 + 15) / 16));
        const int lane_row = row0 + g + a_row;
        float acc[G::MT][G::NT][4];
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
        float2 a[G::MT][2] = {};
        for (int i = 0; i < chunks; ++i, ++q) {
          mbar_wait(full + 8 * (q % stages), (q / stages) & 1);  // chunk q has landed
          __syncthreads();  // every warp is done with chunk q - 1's stage
          issue((q + stages - 1) % stages);
          if (n_mt == 0) continue;
          const float4* stage =
              reinterpret_cast<const float4*>(smem_raw + (q % stages) * G::STAGE);
          if (cs.first) {
            if (i == 0) f32_load_a<C, NS, LDX>(a, xs, src_rows, lane_row, 0, cs.d, pad, tq);
            f32_chunk<C, NS, LDX, true>(acc, a, xs, src_rows, lane_row, stage, i * G::KC, K,
                                        cs.d, pad, nt0, lane);
          } else {
            if (i == 0) f32_load_a<C, NS, LDT>(a, ts, src_rows, lane_row, 0, 1, pad, tq);
            f32_chunk<C, NS, LDT, false>(acc, a, ts, src_rows, lane_row, stage, i * G::KC, K,
                                         1, pad, nt0, lane);
          }
        }
        // accumulator layout: rows g and g + 8 of each m16 tile, channels
        // 8 nt + 2 tq and + 1
#pragma unroll
        for (int nt = 0; nt < G::NT; ++nt) {
          const int col = c0 + (nt0 + nt) * 8 + 2 * tq;
          const float2 bv = *reinterpret_cast<const float2*>(bconv + col);
#pragma unroll
          for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = row0 + 16 * mt + g + 8 * h;
              if (mt >= n_mt || row >= cs.ohi) continue;
              const bool inside = g0 + row >= 0 && g0 + row < L;
              const float v0 = inside ? acc[mt][nt][2 * h] + bv.x : 0.0f;
              const float v1 = inside ? acc[mt][nt][2 * h + 1] + bv.y : 0.0f;
              if (cs.first) {
                *reinterpret_cast<float2*>(ts + static_cast<long long>(row - sc.t_lo) * LDT +
                                           col) =
                    make_float2(fmaxf(v0, v0 * 0.1f), fmaxf(v1, v1 * 0.1f));
              } else {
                float2* xp = reinterpret_cast<float2*>(xs + static_cast<long long>(row) * LDX + col);
                const float2 xv = *xp;
                *xp = make_float2(xv.x + v0, xv.y + v1);
              }
            }
        }
      }
    }
    __syncthreads();
    f32_combine<C, G::CN, LDX>(xs, ob, halo, t0, tile, L, r, sc.n_res, c0);
    __syncthreads();
  }
}

// shared-memory bytes of the f32 launch: the tap ring and its mbarriers,
// then t and x where they lie in shared memory
template <int C, int NS> int f32_smem(const Sched& sc, bool xs) {
  using G = F32Geo<C, NS>;
  return G::STAGES * G::STAGE + G::BARS +
         ((NS == 1 ? sc.t_rows : 0) + (xs ? sc.x_rows : 0)) * G::LD * 4;
}

template <int C, bool XS, int NS>
cudaError_t f32_launch(const void* x, void* out, const void* w, const float* bias, void* scratch,
                       int B, int L, int tile, int halo, const Sched& sc, cudaStream_t stream) {
  const int smem = f32_smem<C, NS>(sc, XS);
  if (smem > kMaxSmem || (!XS && scratch == nullptr)) return cudaErrorInvalidValue;
  auto kernel = f32_resblock_kernel<C, XS, NS>;
  cudaError_t err = lfs2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(NS * ((L + tile - 1) / tile), B);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = NS > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(x), static_cast<float*>(out),
                           static_cast<const float*>(w), bias, static_cast<float*>(scratch), L,
                           tile, halo, sc);
  if (err != cudaSuccess) return err;
  return record_launch(grid, smem, tile);
}

// nsplit 1: x in shared memory (x_in_smem) or in scratch; nsplit 4 (C =
// 256 only, which its taps' layout follows): a cluster of 4 a tile
cudaError_t f32_dispatch(int C, const void* x, void* out, const void* w, const float* bias,
                         void* scratch, int B, int L, int tile, int halo, const Sched& sc,
                         int x_in_smem, int nsplit, cudaStream_t s) {
#define LFS2_F32_ARGS x, out, w, bias, scratch, B, L, tile, halo, sc, s
  if (nsplit != (C == 256 ? 4 : 1) || (nsplit > 1 && x_in_smem)) return cudaErrorInvalidValue;
  switch (C) {
    case 8: return x_in_smem ? f32_launch<8, true, 1>(LFS2_F32_ARGS) : f32_launch<8, false, 1>(LFS2_F32_ARGS);
    case 16: return x_in_smem ? f32_launch<16, true, 1>(LFS2_F32_ARGS) : f32_launch<16, false, 1>(LFS2_F32_ARGS);
    case 32: return x_in_smem ? f32_launch<32, true, 1>(LFS2_F32_ARGS) : f32_launch<32, false, 1>(LFS2_F32_ARGS);
    case 64: return x_in_smem ? f32_launch<64, true, 1>(LFS2_F32_ARGS) : f32_launch<64, false, 1>(LFS2_F32_ARGS);
    case 128: return x_in_smem ? f32_launch<128, true, 1>(LFS2_F32_ARGS) : f32_launch<128, false, 1>(LFS2_F32_ARGS);
    case 256: return f32_launch<256, false, 4>(LFS2_F32_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef LFS2_F32_ARGS
}

// layout: n_res groups of [k, n_pairs, d_0, .., d_{n_pairs-1}]
int parse_spec(const int* layout, int n_res, int C, int halo, Spec* spec) {
  if (n_res < 1 || n_res > kMaxRes) return 0;
  *spec = Spec{};
  spec->n_res = n_res;
  long long w_off = 0;
  int b_off = 0;
  int pos = 0;
  for (int r = 0; r < n_res; ++r) {
    const int k = layout[pos++];
    const int np = layout[pos++];
    if (k < 1 || np < 1 || np > kMaxPairs) return 0;
    spec->k[r] = k;
    spec->n_pairs[r] = np;
    int reach = 0;
    for (int p = 0; p < np; ++p) {
      const int d = layout[pos++];
      if (d < 1) return 0;
      spec->dil[r][p] = d;
      reach += d * (k - 1) / 2 + (k - 1) / 2;
      for (int e = 0; e < 2; ++e) {
        spec->w_off[r][2 * p + e] = w_off;
        spec->b_off[r][2 * p + e] = b_off;
        w_off += static_cast<long long>(k) * C * C;
        b_off += 1;
      }
    }
    if (reach > halo) return 0;
    spec->reach[r] = reach;
  }
  return 1;
}

// the chain of every route, the same for every block: each conv computes the
// rows the convs after it still need, in buffer coordinates (row 0 is
// signal position tile_start - halo)
Sched make_sched(const Spec& spec, int tile, int halo) {
  Sched sc = {};
  sc.n_res = spec.n_res;
  sc.t_lo = halo;
  int n = 0;
  for (int r = 0; r < spec.n_res; ++r) {
    const int k = spec.k[r];
    int lo = halo - spec.reach[r], hi = halo + tile + spec.reach[r];
    sc.res_lo[r] = lo;
    sc.res_hi[r] = hi;
    sc.res_convs[r] = 2 * spec.n_pairs[r];
    for (int p = 0; p < spec.n_pairs[r]; ++p) {
      for (int e = 0; e < 2; ++e) {
        const int d = e == 0 ? spec.dil[r][p] : 1;
        const int q = d * (k - 1) / 2;
        lo += q;
        hi -= q;
        ConvStep& cs = sc.conv[n++];
        cs.w_off = spec.w_off[r][2 * p + e];
        cs.b_off = spec.b_off[r][2 * p + e];
        cs.k = k;
        cs.d = d;
        cs.olo = lo;
        cs.ohi = hi;
        cs.first = e == 0;
        if (e == 0) sc.t_lo = lo < sc.t_lo ? lo : sc.t_lo;
      }
    }
  }
  sc.n_convs = n;
  sc.x_rows = tile + 2 * halo;
  sc.t_rows = tile + 2 * (halo - sc.t_lo);
  return sc;
}

// ===================== the wide route: C > 256, one launch a conv =====================

// A of a conv: row m = b L + l, k index kk = j C + c_in -> the signal at l +
// (j - half) d (zero outside [0, L)), leaky first where LEAKY; 16 bytes of
// consecutive input channels a call
template <typename T, bool LEAKY> struct ConvRows {
  const T* x;
  int L, C, d, half;
  __device__ __forceinline__ uint4 vec(int m, int kk) const {
    const int j = kk / C, ci = kk - j * C;
    const int b = m / L, l = m - b * L;
    const int src = l + (j - half) * d;
    if (src < 0 || src >= L) return make_uint4(0, 0, 0, 0);
    uint4 v = *reinterpret_cast<const uint4*>(x + (static_cast<long long>(b) * L + src) * C + ci);
    if (LEAKY) {
      T* e = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int q = 0; q < lfs2::gemm::vec_elems<T>(); ++q) {
        const float f = lfs2::to_f(e[q]);
        e[q] = lfs2::from_f<T>(fmaxf(f, f * 0.1f));
      }
    }
    return v;
  }
};

// the first conv's epilogue: y = leaky(acc + b), rounded
template <typename T> struct ConvFirstEp {
  T* y;
  const float* bias;
  int C;
  __device__ void operator()(const float (&acc)[4][4][4], int mw, int nw, int lane, int M) const {
    lfs2::gemm::for_each_pair(acc, mw, nw, lane, M, [&](int m, int n, int, float v0, float v1) {
      const float a = v0 + bias[n], b = v1 + bias[n + 1];
      y[static_cast<size_t>(m) * C + n] = lfs2::from_f<T>(fmaxf(a, a * 0.1f));
      y[static_cast<size_t>(m) * C + n + 1] = lfs2::from_f<T>(fmaxf(b, b * 0.1f));
    });
  }
};

// the second conv's epilogue: out = x + round(acc + b), rounded (x may be out)
template <typename T> struct ConvSecondEp {
  T* out;
  const T* x;
  const float* bias;
  int C;
  __device__ void operator()(const float (&acc)[4][4][4], int mw, int nw, int lane, int M) const {
    lfs2::gemm::for_each_pair(acc, mw, nw, lane, M, [&](int m, int n, int, float v0, float v1) {
      const size_t o = static_cast<size_t>(m) * C + n;
      const float a = lfs2::round_to<T>(v0 + bias[n]), b = lfs2::round_to<T>(v1 + bias[n + 1]);
      const float xa = lfs2::to_f(x[o]), xb = lfs2::to_f(x[o + 1]);
      out[o] = lfs2::from_f<T>(xa + a);
      out[o + 1] = lfs2::from_f<T>(xb + b);
    });
  }
};

template <typename T>
cudaError_t wide_chain(const T* x, T* out, const T* w, const float* bias, T* y, int B, int L,
                       int C, const Spec& spec, cudaStream_t s) {
  using lfs2::gemm::Mat;
  const int M = B * L, k = spec.k[0], K = k * C, half = (k - 1) / 2;
  const T* cur = x;
  int rec[5] = {};
  for (int p = 0; p < spec.n_pairs[0]; ++p) {
    const T* w1 = w + spec.w_off[0][2 * p];
    const T* w2 = w + spec.w_off[0][2 * p + 1];
    const float* b1 = bias + spec.b_off[0][2 * p] * C;
    const float* b2 = bias + spec.b_off[0][2 * p + 1] * C;
    cudaError_t e = lfs2::gemm::launch<T, true, true>(
        ConvRows<T, true>{cur, L, C, spec.dil[0][p], half}, Mat<T>{w1, K, 1},
        ConvFirstEp<T>{y, b1, C}, M, C, K, K, s, rec);
    if (e != cudaSuccess) return e;
    e = lfs2::gemm::launch<T, true, true>(ConvRows<T, false>{y, L, C, 1, half}, Mat<T>{w2, K, 1},
                                          ConvSecondEp<T>{out, cur, b2, C}, M, C, K, K, s, rec);
    if (e != cudaSuccess) return e;
    cur = out;
  }
  for (int i = 0; i < 5; ++i) g_last_launch[i] = rec[i];
  return cudaSuccess;
}

}  // namespace

LFS2_DEFINE_ERROR_STRING

// The taps of resblock r, pair p are w[conv], conv = r*2*n_pairs + 2p (+1
// for the second conv), each k * C * C elements as _kernel_taps lays them
// (f32: hi and lo, 2 floats an element); bias is (n_convs, C) f32. bf16
// takes wgmma (C >= 128) or mma.sync, scratch and x_in_smem unused; f32
// takes split TF32, x in shared memory or (x_in_smem 0) in scratch,
// blocks * (tile + 2 halo) * C floats; at C = 256 (nsplit 4) a cluster of
// 4 blocks a tile, x and t in scratch, B * tiles * (x_rows + t_rows) * C
// floats.
LFS2_EXPORT int lfs2_resblock(const void* x, void* out, const void* w, const float* bias,
                              void* scratch, int B, int L, int C, int tile, int halo,
                              const int* layout, int n_res, int x_in_smem, int nsplit,
                              int dtype, void* stream) {
  Spec spec;
  if (B < 1 || L < 1 || tile < 1 || !parse_spec(layout, n_res, C, halo, &spec))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == lfs2::kBF16
          ? bf16_dispatch(C, x, out, w, bias, B, L, tile, halo, make_sched(spec, tile, halo), s)
          : f32_dispatch(C, x, out, w, bias, scratch, B, L, tile, halo,
                         make_sched(spec, tile, halo), x_in_smem, nsplit, s);
  return static_cast<int>(err);
}

// copies into out[0..4] the grid (x, y, z), shared-memory bytes and tile of
// the latest accepted launch; zeros before the first
LFS2_EXPORT int lfs2_resblock_last_launch(int* out) {
  for (int i = 0; i < 5; ++i) out[i] = g_last_launch[i];
  return 0;
}

// The wide route (C > 256, a multiple of 128): one resblock ([k, n_pairs,
// d_0, ..]), its taps each conv's (C_out, k, C_in) in order, the working
// dtype; bias (n_convs, C) f32; y (B, L, C) scratch of the working dtype.
// Each conv is one launch; the latest is recorded (its tile: 128 rows).
LFS2_EXPORT int lfs2_resblock_wide(const void* x, void* out, const void* w, const float* bias,
                                   void* y, int B, int L, int C, const int* layout, int dtype,
                                   void* stream) {
  Spec spec;
  if (B < 1 || L < 1 || C < 128 || C % 128 != 0 || !parse_spec(layout, 1, C, 1 << 30, &spec))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == lfs2::kBF16
          ? wide_chain(static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
                       static_cast<const __nv_bfloat16*>(w), bias, static_cast<__nv_bfloat16*>(y),
                       B, L, C, spec, s)
          : wide_chain(static_cast<const float*>(x), static_cast<float*>(out),
                       static_cast<const float*>(w), bias, static_cast<float*>(y), B, L, C, spec, s);
  return static_cast<int>(err);
}

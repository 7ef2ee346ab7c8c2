// flash_attention, bf16 route: softmax(q k^T / sqrt(d)) v with a key-padding
// mask and hashed dropout on the probabilities, forward and backward, on
// Hopper's tensor cores.
//
// Replaces lightningfastspeech2_tpu/ops/pallas_attention.py _fwd_kernel and
// _bwd_kernel for bf16 q, k, v (B, H, T, D), D = 128 or 256 (the kernels are
// templates on D), T % 128 == 0; mask is (B, T) int32, nonzero = valid key.
// f32 inputs take flash_attention.cu (split-TF32 mma.sync).
//
// What it computes, as flash_attention.cu does: scores q.k^T summed in f32,
// then scaled by 1/sqrt(d) in f32; a padded key's score is -1e30 (queries
// are not masked); an online softmax whose denominator sums the undropped p;
// the keep mask lfs2::attn_keep on the global (query row, key column) with
// seed + b * H + h; p rounded to bf16 before P.V; o = acc / (l * (1 - rate));
// the f32 log-sum-exp saved for the backward. The backward is the split that
// needs no atomics: a dQ pass (which also writes D = rowsum(dO o O), from
// the forward's output before its bf16 rounding, so that D cancels dP
// exactly where one key takes all the weight), then a K-major dK/dV pass;
// dS is rounded to bf16 before its products, dK and dV sum in f32
// registers.
//
// What bounds it on an H100: the tensor-core products, 4 T^2 d operations
// per (b, h) forward and 14 T^2 d backward (7 products: the split recomputes
// S and dP in both passes, where a fused backward needs 5), and beside them
// the per-score work on the CUDA cores (scale, mask, exp, bf16 round, the
// keep hash of about ten integer operations).
//
// Design. Each block has one producer warpgroup and two consumer warpgroups
// of 64 rows each. One producer thread streams tiles through a ring of
// shared-memory stages with TMA (cp.async.bulk.tensor, 128-byte swizzle,
// each 128-column bf16 row as two 64-column boxes), tracked by full and
// empty mbarriers; setmaxnreg gives the consumers 240 registers a thread
// and the producer 24 (232 and 40 at D = 256). The consumers run wgmma: S = Q.K^T reads both
// operands from shared memory (K-major), and P (or dS) goes from the f32
// accumulator straight into bf16 A-register fragments for the next product,
// whose B operand (V, K, Q or dO) is read MN-major through the transpose
// bit. In the accumulator layout a row's values sit on the four threads of
// a quad, so row statistics take two shuffles. The two consumer warpgroups
// share the SM, so one's softmax overlaps the other's products; the dK/dV
// pass also runs each warpgroup one tile ahead of itself (see there). The
// forward and the dQ pass give each consumer warpgroup 64 rows; the dK/dV
// pass gives one warpgroup P and dV, the other dS and dK.
//
// At D = 256 the tiles are twice as wide, and a 64 x 256 f32 accumulator
// would be 128 registers a thread, past the 168 ptxas gives a thread of a
// 384-thread block. So a thread keeps a 64 x 128 accumulator at every D:
// at D = 256 the forward and the dQ pass give a block 64 query rows, and
// both consumer warpgroups form the same scores and each accumulates one
// half of the head dim; the dK/dV pass gives each 64 keys two blocks, one a
// half of the head dim each. The streamed tiles narrow to fit shared
// memory: 64-key tiles in the forward, 32-query tiles in the dK/dV pass
// (scores of those as m64n32 products).
//
// A key tile whose keys are all padded is skipped when its item has a valid
// key (exp(-1e30 - m) is exactly 0 there). An item with no valid key takes
// every tile and scores its padded keys 0 instead of -1e30: the same uniform
// softmax over every key that the JAX kernel gives, with an lse that the
// backward can use. A padded key's score is a constant, so its dS is 0: the
// gradient of the function (and of the plain version), where the JAX
// kernel's backward gives an item with no valid key a nonzero dQ and dK.
#include <cuda.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kRowBytes = 128;  // one 64-column bf16 box row
constexpr float kNeg = -1e30f;

struct Params {
  const int* mask;
  const int* seed;
  const float* o32;     // the forward's output before its bf16 rounding
  const __nv_bfloat16* dout;
  __nv_bfloat16* out;   // o (forward) or dq (dQ pass)
  float* out32;         // the forward's f32 output
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* lse;
  float* dsum;          // D_i, written by the dQ pass
  int H, T;
  float scale;
  unsigned threshold;
  float inv_keep;
};

// ---- shared-memory addresses, mbarriers, TMA ------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the phase of parity `parity` to complete. A wait that has not
// completed after 2^26 tries (seconds) traps: a fault, not a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  for (unsigned tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1u << 26)) __trap();
  }
}

// one box of a 2-D tensor map (columns c, rows r) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c, int r,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(bar)
      : "memory");
}

// `rows` rows of D bf16 as their D / 64 column boxes, one after the other
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, int row, int rows,
                                         uint32_t bar) {
#pragma unroll 1
  for (int h = 0; h < D / 64; ++h) tma_load(dst + h * rows * kRowBytes, map, 64 * h, row, bar);
}

// contiguous bytes (16-byte aligned, a multiple of 16)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, unsigned bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------
// Shared-memory matrix descriptors, 128-byte swizzle, as a low word (start
// address >> 4, leading byte offset) and the high word kDescHi (stride byte
// offset, swizzle mode). K-major operands use SBO = 1024, the stride of
// 8-row groups (LBO is unused). MN-major operands are taken 64 columns (one
// swizzle atom) at a time, so only the stride of 8-row groups along K
// matters (SBO; LBO would be the stride between 64-column atoms); both
// offsets are set to it.
constexpr uint32_t kDescHi = (1024u >> 4) | (1u << 30);

__device__ __forceinline__ uint32_t desc_lo(uint32_t addr) {
  return ((addr & 0x3FFFFu) >> 4) | ((1024u >> 4) << 16);
}

// x, opaque to the compiler: descriptors derived from it inside a loop are
// recomputed there (one add each) instead of hoisted into 32 live registers
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(x));
  return x;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers an in-flight wgmma reads or writes, pinned at this point: placed
// after the wait_group that retires the product, so that the compiler
// neither reuses them for other values nor touches them before it.
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

template <int N> __device__ __forceinline__ void copy_frags(uint32_t (&to)[N][4],
                                                           const uint32_t (&from)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) to[i][j] = from[i][j];
}

template <unsigned N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <unsigned N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Descriptor (from a tile's desc_lo) of k-step kk (16 of the 128 head-dim
// columns) of a K-major tile of `rows` rows stored as two 64-column boxes,
// from row `row0` on. Smem offsets stay below 2^18, so the add cannot carry
// out of the address field.
__device__ __forceinline__ uint32_t kmajor(uint32_t lo, int rows, int row0, int kk) {
  return lo + (((kk >> 2) * rows * kRowBytes + row0 * kRowBytes + (kk & 3) * 32) >> 4);
}

// Descriptor of k-step kk (rows 16 kk .. 16 kk + 15) of box `half` (head
// columns 64 half ..) of a tile of `rows` rows, as an MN-major B operand.
__device__ __forceinline__ uint32_t mnmajor(uint32_t lo, int rows, int half, int kk) {
  return lo + ((half * rows * kRowBytes + kk * 16 * kRowBytes) >> 4);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Marks in flags[t] whether key tile t (of `tile` keys) of the item's mask
// row holds a valid key, and returns whether any does. All threads of the
// block call it; it synchronises the block.
__device__ __forceinline__ bool scan_mask(const int* mrow, int T, int tile, int* flags) {
  const int nt = T / tile;
  for (int i = threadIdx.x; i < nt; i += blockDim.x) flags[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < T; i += blockDim.x)
    if (mrow[i]) flags[i / tile] = 1;
  __syncthreads();
  bool any = false;
  for (int i = 0; i < nt; ++i) any |= flags[i] != 0;
  return any;
}

__device__ __forceinline__ unsigned seed_bh(const Params& p, int b, int h) {
  return static_cast<unsigned>(*p.seed) + static_cast<unsigned>(b * p.H + h);
}

// the keep test with the query row's factor r * 2654435761 precomputed
__device__ __forceinline__ bool keep_at(unsigned row_hash, int c, unsigned sbh, unsigned threshold) {
  return lfs2::fmix((row_hash ^ (static_cast<unsigned>(c) * 1013904223u)) + sbh) >= threshold;
}

// d (64 x 32) += A (smem, K-major) * B (smem, K-major)^T; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint32_t da, uint32_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %19, 0;\n"
      "mov.b64 da, {%16, %18};\nmov.b64 db, {%17, %18};\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(da), "r"(db), "r"(kDescHi), "r"(scale_d));
}

// d (64 x 64) += A (smem, K-major) * B (smem, K-major)^T; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint32_t da, uint32_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %35, 0;\n"
      "mov.b64 da, {%32, %34};\nmov.b64 db, {%33, %34};\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(da), "r"(db), "r"(kDescHi), "r"(scale_d));
}

// d (64 x 128) += A (smem, K-major) * B (smem, K-major)^T; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint32_t da, uint32_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %67, 0;\n"
      "mov.b64 da, {%64, %66};\nmov.b64 db, {%65, %66};\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(da), "r"(db), "r"(kDescHi), "r"(scale_d));
}

// d (64 x 64) += A (registers) * B (smem, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64_t(float (&d)[32], const uint32_t (&a)[4], uint32_t db) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\nsetp.ne.b32 p, %38, 0;\n"
      "mov.b64 db, {%36, %37};\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(db), "r"(kDescHi), "r"(1));
}

constexpr int kThreads = 384;   // producer warpgroup + two consumer warpgroups
constexpr int kMaxTiles = 512;  // key-tile flags: T <= 512 * 32

// Registers a thread after the split: the producer's code at D = 256 (four
// boxes a tile) needs more than 24, so it takes 40 and each consumer 232
// (128 x (40 + 2 x 232) fits the SM's 64K registers, as 24 + 2 x 240 does)
template <int D> __device__ __forceinline__ void producer_regs() {
  if constexpr (D == 128) setmaxnreg_dec<24>();
  else setmaxnreg_dec<40>();
}
template <int D> __device__ __forceinline__ void consumer_regs() {
  if constexpr (D == 128) setmaxnreg_inc<240>();
  else setmaxnreg_inc<232>();
}

// scores of N columns: d (64 x N) += A (smem, K-major) * B (smem, K-major)^T
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint32_t da, uint32_t db, int scale_d) {
  if constexpr (N == 32) wgmma_ss_n32(d, da, db, scale_d);
  else if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}

// shared memory of one block, from a 1024-byte aligned base (the swizzle's
// repeat): tiles first, then the mbarriers and the key-tile flags. A tile
// of r rows is r * D * 2 bytes.
template <int D> struct FwdLayout {
  static constexpr int kQRows = D == 128 ? 128 : 64;  // query rows a block
  static constexpr int kKT = D == 128 ? 128 : 64;     // keys a streamed tile
  static constexpr int kStages = 2;                   // ring depth
  static constexpr int kQ = 0;                        // the block's query rows
  static constexpr int kStage0 = kQRows * D * 2;      // K (kKT keys), V, mask
  static constexpr int kStageBytes = 2 * kKT * D * 2 + 1024;
  static constexpr int kBars = kStage0 + kStages * kStageBytes;
  static constexpr int kFlags = kBars + 64;
  static constexpr int kBytes = kFlags + kMaxTiles * 4;
};

template <int D> struct DqLayout {
  static constexpr int kQRows = D == 128 ? 128 : 64;  // query rows a block
  static constexpr int kKT = 64;                      // keys a streamed tile
  static constexpr int kStages = 2;
  static constexpr int kQ = 0, kDO = kQRows * D * 2;  // the block's query rows, each
  static constexpr int kStage0 = 2 * kQRows * D * 2;  // K (kKT keys), V, mask
  static constexpr int kStageBytes = 2 * kKT * D * 2 + 1024;
  static constexpr int kBars = kStage0 + kStages * kStageBytes;
  static constexpr int kFlags = kBars + 64;
  static constexpr int kBytes = kFlags + kMaxTiles * 4;
};

template <int D> struct DkvLayout {
  static constexpr int kHalves = D / 128;             // blocks a 64-key tile, a head-dim half each
  // a consumer holds two stages at once (see the kernel), so a third loads
  static constexpr int kStages = 3;
  static constexpr int kQT = D == 128 ? 64 : 32;      // queries a tile
  static constexpr int kK = 0, kV = 64 * D * 2;       // 64 keys each
  static constexpr int kStage0 = 2 * 64 * D * 2;      // Q (kQT queries), dO, lse, D
  static constexpr int kStageBytes = 2 * kQT * D * 2 + 1024;
  static constexpr int kX0 = kStage0 + kStages * kStageBytes;  // P (f32) and keep bits, S side -> dP side
  static constexpr int kXBytes = 64 * kQT * 4 + 1024;
  static constexpr int kBars = kX0 + 2 * kXBytes;
  static constexpr int kFlags = kBars + 64;
  static constexpr int kBytes = kFlags + kMaxTiles * 4;
};

// each layout plus the 1024 bytes that align its base; 2 kStages + 1
// mbarriers in the 64 bytes at kBars
constexpr int kSmemMax = 227 * 1024;  // a block's shared memory on an H100
template <int D> constexpr bool fits() {
  return FwdLayout<D>::kBytes + 1024 <= kSmemMax && DqLayout<D>::kBytes + 1024 <= kSmemMax &&
         DkvLayout<D>::kBytes + 1024 <= kSmemMax && (2 * DkvLayout<D>::kStages + 1) * 8 <= 64;
}
static_assert(fits<128>() && fits<256>(), "shared memory");

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

// bars[0, kStages): full, [kStages, 2 kStages): empty, [2 kStages]: the
// tiles loaded once
template <int kStages> __device__ __forceinline__ void init_bars(uint32_t bars) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), 8);  // lane 0 of each consumer warp
    }
    mbar_init(bars + 8 * 2 * kStages, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// The consumer thread's place in the m64 accumulator layout: rows r0 and
// r0 + 8 of its warpgroup's 64, columns 8 j + c2 + {0, 1}.
struct Lane {
  int cw, lane, r0, c2;
  __device__ __forceinline__ explicit Lane(int consumer) {
    cw = consumer;
    const int tid = threadIdx.x & 127;
    lane = tid & 31;
    r0 = 16 * (tid >> 5) + (lane >> 2);
    c2 = 2 * (lane & 3);
  }
};

// rows r and r + 8 of a (T, D) slab from two 64-column accumulators
__device__ __forceinline__ void store2(__nv_bfloat16* at, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(float* at, float x, float y) {
  *reinterpret_cast<float2*>(at) = make_float2(x, y);
}

// columns c0 .. c0 + 127 of the rows, acc[h] holding columns c0 + 64 h ..
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* row, const float (&acc)[2][32], int c0, int c2,
                                           float n0, float n1) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + 64 * h + 8 * j + c2;
      store2(row + c, acc[h][4 * j] * n0, acc[h][4 * j + 1] * n0);
      store2(row + 8 * D + c, acc[h][4 * j + 2] * n1, acc[h][4 * j + 3] * n1);
    }
}

__device__ __forceinline__ void zero_acc(float (&acc)[2][32]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.0f;
}
__device__ __forceinline__ void hold_acc(float (&acc)[2][32]) {
  hold(acc[0]);
  hold(acc[1]);
}

// ---- forward ---------------------------------------------------------------
// grid (T / QR, H, B): QR query rows a block; K/V stream in KT-key tiles.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, const Params p) {
  using L_ = FwdLayout<D>;
  constexpr int kStages = L_::kStages, KT = L_::kKT, QR = L_::kQRows;
  constexpr int kTileK = KT * D * 2, kTileQ = QR * D * 2;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem), bars = base + L_::kBars;
  const uint32_t qbar = bars + 8 * 2 * kStages;
  int* flags = reinterpret_cast<int*>(smem + L_::kFlags);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QR, T = p.T, nt = T / KT;
  const int bh_row = (b * p.H + h) * T;
  const int* mrow = p.mask + static_cast<size_t>(b) * T;

  init_bars<kStages>(bars);
  const bool any = scan_mask(mrow, T, KT, flags);

  if (threadIdx.x < 128) {  // producer
    producer_regs<D>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, kTileQ);
      tma_tile<D>(base + L_::kQ, &tq, bh_row + q0, QR, qbar);
      for (int t = 0, it = 0; t < nt; ++t) {
        if (any && !flags[t]) continue;
        const int s = it % kStages;
        const uint32_t stage = base + L_::kStage0 + s * L_::kStageBytes;
        mbar_wait(bars + 8 * (kStages + s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(bars + 8 * s, 2 * kTileK + KT * 4);
        tma_tile<D>(stage, &tk, bh_row + t * KT, KT, bars + 8 * s);
        tma_tile<D>(stage + kTileK, &tv, bh_row + t * KT, KT, bars + 8 * s);
        bulk_load(stage + 2 * kTileK, mrow + t * KT, KT * 4, bars + 8 * s);
        ++it;
      }
    }
  } else {  // consumers: 64 query rows each (D = 128), or the same 64 (D = 256)
    consumer_regs<D>();
    const Lane L(threadIdx.x / 128 - 1);
    const int rowoff = D == 128 ? 64 * L.cw : 0;  // the warpgroup's rows in the block
    const int hb = D == 128 ? 0 : 2 * L.cw;       // its first 64-column box of the output
    const int g0 = q0 + rowoff + L.r0;            // this thread's rows g0, g0 + 8
    const unsigned sbh = seed_bh(p, b, h), thr = p.threshold;
    const bool drop = thr != 0u;
    const unsigned rh0 = static_cast<unsigned>(g0) * 2654435761u;
    const unsigned rh1 = static_cast<unsigned>(g0 + 8) * 2654435761u;
    const float mval = any ? kNeg : 0.0f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
    float oacc[2][32];  // head columns 64 (hb + h) .. + 63
    zero_acc(oacc);
    const uint32_t qt = base + L_::kQ;
    mbar_wait(qbar, 0);
    for (int t = 0, it = 0; t < nt; ++t) {
      if (any && !flags[t]) continue;
      const int s = it % kStages;
      const uint32_t stage = base + L_::kStage0 + s * L_::kStageBytes;
      const int* mk = reinterpret_cast<const int*>(smem + L_::kStage0 + s * L_::kStageBytes + 2 * kTileK);
      mbar_wait(bars + 8 * s, (it / kStages) & 1);

      const uint32_t qd = opaque(desc_lo(qt)), kd = opaque(desc_lo(stage));
      float sc[KT / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<KT>(sc, kmajor(qd, QR, rowoff, kk), kmajor(kd, KT, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();

      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        const int2 vm = *reinterpret_cast<const int2*>(mk + 8 * j + L.c2);
        sc[4 * j] = vm.x ? sc[4 * j] * p.scale : mval;
        sc[4 * j + 1] = vm.y ? sc[4 * j + 1] * p.scale : mval;
        sc[4 * j + 2] = vm.x ? sc[4 * j + 2] * p.scale : mval;
        sc[4 * j + 3] = vm.y ? sc[4 * j + 3] * p.scale : mval;
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      const float a0 = __expf(m0 - mn0), a1 = __expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.0f, rs1 = 0.0f;
      uint32_t pf[KT / 16][4];
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        const int c = t * KT + 8 * j + L.c2;
        float e0 = __expf(sc[4 * j] - m0), e1 = __expf(sc[4 * j + 1] - m0);
        float e2 = __expf(sc[4 * j + 2] - m1), e3 = __expf(sc[4 * j + 3] - m1);
        rs0 += e0 + e1;
        rs1 += e2 + e3;
        if (drop) {
          if (!keep_at(rh0, c, sbh, thr)) e0 = 0.0f;
          if (!keep_at(rh0, c + 1, sbh, thr)) e1 = 0.0f;
          if (!keep_at(rh1, c, sbh, thr)) e2 = 0.0f;
          if (!keep_at(rh1, c + 1, sbh, thr)) e3 = 0.0f;
        }
        pf[j >> 1][(j & 1) * 2] = pack_bf16(e0, e1);
        pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(e2, e3);
      }
      l0 = l0 * a0 + rs0;  // this thread's part of the row sum
      l1 = l1 * a1 + rs1;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          oacc[hh][4 * j] *= a0; oacc[hh][4 * j + 1] *= a0;
          oacc[hh][4 * j + 2] *= a1; oacc[hh][4 * j + 3] *= a1;
        }
      const uint32_t vd = opaque(desc_lo(stage + kTileK));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          wgmma_rs_n64_t(oacc[hh], pf[kk], mnmajor(vd, KT, hb + hh, kk));
      wgmma_commit();
      wgmma_wait<0>();
      hold_acc(oacc);
      if (L.lane == 0) mbar_arrive(bars + 8 * (kStages + s));
      ++it;
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float keep = drop ? 1.0f / p.inv_keep : 1.0f;
    const size_t off = (static_cast<size_t>(bh_row) + g0) * D;
    const float n0 = 1.0f / (l0 * keep), n1 = 1.0f / (l1 * keep);
    store_rows<D>(p.out + off, oacc, 64 * hb, L.c2, n0, n1);
    store_rows<D>(p.out32 + off, oacc, 64 * hb, L.c2, n0, n1);
    if ((L.lane & 3) == 0 && hb == 0) {
      p.lse[bh_row + g0] = m0 + __logf(l0);
      p.lse[bh_row + g0 + 8] = m1 + __logf(l1);
    }
  }
}

// ---- backward, dQ pass -------------------------------------------------------
// grid (T / QR, H, B): QR query rows a block; K/V stream in KT-key tiles.
// Also writes D_i = rowsum(dO o O), which equals sum_j p_ij dp_ij with
// dropout too, for the dK/dV pass.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dq_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
          const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
          const Params p) {
  using L_ = DqLayout<D>;
  constexpr int kStages = L_::kStages, KT = L_::kKT, QR = L_::kQRows;
  constexpr int kTileK = KT * D * 2, kTileQ = QR * D * 2;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem), bars = base + L_::kBars;
  const uint32_t qbar = bars + 8 * 2 * kStages;
  int* flags = reinterpret_cast<int*>(smem + L_::kFlags);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QR, T = p.T, nt = T / KT;
  const int bh_row = (b * p.H + h) * T;
  const int* mrow = p.mask + static_cast<size_t>(b) * T;

  init_bars<kStages>(bars);
  const bool any = scan_mask(mrow, T, KT, flags);

  if (threadIdx.x < 128) {  // producer
    producer_regs<D>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, 2 * kTileQ);
      tma_tile<D>(base + L_::kQ, &tq, bh_row + q0, QR, qbar);
      tma_tile<D>(base + L_::kDO, &tdo, bh_row + q0, QR, qbar);
      for (int t = 0, it = 0; t < nt; ++t) {
        if (any && !flags[t]) continue;
        const int s = it % kStages;
        const uint32_t stage = base + L_::kStage0 + s * L_::kStageBytes;
        mbar_wait(bars + 8 * (kStages + s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(bars + 8 * s, 2 * kTileK + KT * 4);
        tma_tile<D>(stage, &tk, bh_row + t * KT, KT, bars + 8 * s);
        tma_tile<D>(stage + kTileK, &tv, bh_row + t * KT, KT, bars + 8 * s);
        bulk_load(stage + 2 * kTileK, mrow + t * KT, KT * 4, bars + 8 * s);
        ++it;
      }
    }
  } else {  // consumers: 64 query rows each (D = 128), or the same 64 (D = 256)
    consumer_regs<D>();
    const Lane L(threadIdx.x / 128 - 1);
    const int rowoff = D == 128 ? 64 * L.cw : 0;  // the warpgroup's rows in the block
    const int hb = D == 128 ? 0 : 2 * L.cw;       // its first 64-column box of dQ
    const int g0 = q0 + rowoff + L.r0;
    const unsigned sbh = seed_bh(p, b, h), thr = p.threshold;
    const bool drop = thr != 0u;
    const unsigned rh0 = static_cast<unsigned>(g0) * 2654435761u;
    const unsigned rh1 = static_cast<unsigned>(g0 + 8) * 2654435761u;
    const float mval = any ? kNeg : 0.0f, scale = p.scale, inv_keep = p.inv_keep;
    // D for rows g0 and g0 + 8: the quad's four threads take D / 4 columns each
    float dd[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const size_t off = (static_cast<size_t>(bh_row) + g0 + 8 * i) * D + (D / 4) * (L.lane & 3);
      float acc = 0.0f;
#pragma unroll
      for (int v = 0; v < D / 32; ++v) {
        float x[8], y[8];
        lfs2::load_vec<8>(p.dout + off + 8 * v, x);
        lfs2::load_vec<8>(p.o32 + off + 8 * v, y);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc += x[e] * y[e];
      }
      dd[i] = quad_sum(acc);
    }
    if ((L.lane & 3) == 0 && hb == 0) {
      p.dsum[bh_row + g0] = dd[0];
      p.dsum[bh_row + g0 + 8] = dd[1];
    }
    const float lse0 = p.lse[bh_row + g0], lse1 = p.lse[bh_row + g0 + 8];
    float qacc[2][32];  // dQ, head columns 64 (hb + h) .. + 63
    zero_acc(qacc);
    const uint32_t qt = base + L_::kQ, dot = base + L_::kDO;
    mbar_wait(qbar, 0);
    for (int t = 0, it = 0; t < nt; ++t) {
      if (any && !flags[t]) continue;
      const int s = it % kStages;
      const uint32_t stage = base + L_::kStage0 + s * L_::kStageBytes;
      const int* mk = reinterpret_cast<const int*>(smem + L_::kStage0 + s * L_::kStageBytes + 2 * kTileK);
      mbar_wait(bars + 8 * s, (it / kStages) & 1);

      const uint32_t qd = opaque(desc_lo(qt)), dod = opaque(desc_lo(dot));
      const uint32_t kd = opaque(desc_lo(stage)), vd = opaque(desc_lo(stage + kTileK));
      float sc[KT / 2], dp[KT / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<KT>(sc, kmajor(qd, QR, rowoff, kk), kmajor(kd, KT, 0, kk), kk > 0);
        wgmma_ss<KT>(dp, kmajor(dod, QR, rowoff, kk), kmajor(vd, KT, 0, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();

      uint32_t df[KT / 16][4];
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        const int2 vm = *reinterpret_cast<const int2*>(mk + 8 * j + L.c2);
        const int c = t * KT + 8 * j + L.c2;
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = (e & 1) ? vm.y : vm.x;
          const float pv = __expf((valid ? sc[4 * j + e] * scale : mval) - (e < 2 ? lse0 : lse1));
          float dpv = dp[4 * j + e];
          if (drop)
            dpv = keep_at(e < 2 ? rh0 : rh1, c + (e & 1), sbh, thr) ? dpv * inv_keep : 0.0f;
          ds[e] = valid ? pv * (dpv - dd[e >> 1]) * scale : 0.0f;
        }
        df[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
        df[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          wgmma_rs_n64_t(qacc[hh], df[kk], mnmajor(kd, KT, hb + hh, kk));
      wgmma_commit();
      wgmma_wait<0>();
      hold_acc(qacc);
      if (L.lane == 0) mbar_arrive(bars + 8 * (kStages + s));
      ++it;
    }
    store_rows<D>(p.out + (static_cast<size_t>(bh_row) + g0) * D, qacc, 64 * hb, L.c2, 1.0f,
                  1.0f);
  }
}

// ---- backward, dK/dV pass ------------------------------------------------------
// grid (T / 64 * D / 128, H, B): 64 keys and one 128-column half of the
// head dim a block; Q, dO, lse and D stream in QT-query tiles. The scores are formed transposed (S^T = K.Q^T, dP^T = V.dO^T), so
// P^T and dS^T are already A fragments for dV += P^T.dO and dK += dS^T.Q.
// The two consumer warpgroups split the work, not the keys: the S side
// forms P (the exp and the keep hash) and dV, the dP side dS and dK. So a
// thread holds one f32 accumulator of 64 x D, not two: both in one thread
// with the scores beside them made ptxas spill. The S side hands the
// undropped P (f32) and the keep bits to the dP side through a double
// buffer in shared memory; both sides hold the same accumulator layout, so
// thread i reads what thread i wrote. Named barriers 1-2 mark a buffer
// full, 3-4 empty.
//
// Each side runs one tile ahead: it issues the next query tile's S^T or
// dP^T, then this tile's dV or dK product, and does the next tile's
// per-score work while both run (wait_group 1 retires the first). So it
// holds two ring stages at once, and a third loads meanwhile. The other
// kernels issue their products in order: on an H100 the same run-ahead
// made the forward and the dQ pass slower (PERF.md).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dkv_sm90_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                const Params p) {
  using L_ = DkvLayout<D>;
  constexpr int QT = L_::kQT, kStages = L_::kStages, kTileQ = QT * D * 2, kTileK = 64 * D * 2;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem), bars = base + L_::kBars;
  const uint32_t kvbar = bars + 8 * 2 * kStages;
  int* flags = reinterpret_cast<int*>(smem + L_::kFlags);
  const int kb = blockIdx.x / L_::kHalves, hb = 2 * (blockIdx.x % L_::kHalves);
  const int b = blockIdx.z, h = blockIdx.y, k0 = kb * 64, T = p.T, nt = T / QT;
  const int bh_row = (b * p.H + h) * T;
  const int* mrow = p.mask + static_cast<size_t>(b) * T;
  auto stage = [&](int s) { return base + L_::kStage0 + s * L_::kStageBytes; };

  init_bars<kStages>(bars);
  const bool any = scan_mask(mrow, T, 64, flags);
  if (any && !flags[kb]) {
    // every key of the block padded, a valid one elsewhere: P = 0 exactly,
    // so dK = dV = 0 (the block's 128 columns of them)
    for (int i = threadIdx.x; i < 64 * 128 / 8; i += kThreads) {
      const size_t at = (static_cast<size_t>(bh_row) + k0 + i / 16) * D + 64 * hb + 8 * (i % 16);
      *reinterpret_cast<uint4*>(p.dk + at) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(p.dv + at) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  if (threadIdx.x < 128) {  // producer
    producer_regs<D>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kvbar, 2 * kTileK);
      tma_tile<D>(base + L_::kK, &tk, bh_row + k0, 64, kvbar);
      tma_tile<D>(base + L_::kV, &tv, bh_row + k0, 64, kvbar);
      for (int t = 0; t < nt; ++t) {
        const int s = t % kStages;
        mbar_wait(bars + 8 * (kStages + s), ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(bars + 8 * s, 2 * kTileQ + 2 * QT * 4);
        tma_tile<D>(stage(s), &tq, bh_row + t * QT, QT, bars + 8 * s);
        tma_tile<D>(stage(s) + kTileQ, &tdo, bh_row + t * QT, QT, bars + 8 * s);
        bulk_load(stage(s) + 2 * kTileQ, p.lse + bh_row + t * QT, QT * 4, bars + 8 * s);
        bulk_load(stage(s) + 2 * kTileQ + QT * 4, p.dsum + bh_row + t * QT, QT * 4,
                  bars + 8 * s);
      }
    }
  } else {  // consumers: the S side (warpgroup 1) and the dP side (warpgroup 2)
    consumer_regs<D>();
    const Lane L(threadIdx.x / 128 - 1);
    const bool s_side = L.cw == 0;
    const int tid = threadIdx.x & 127;
    const int g0 = k0 + L.r0;  // this thread's keys g0, g0 + 8
    const unsigned sbh = seed_bh(p, b, h), thr = p.threshold;
    const bool drop = thr != 0u;
    const unsigned kh0 = static_cast<unsigned>(g0) * 1013904223u;
    const unsigned kh1 = static_cast<unsigned>(g0 + 8) * 1013904223u;
    const float mval = any ? kNeg : 0.0f, scale = p.scale, inv_keep = p.inv_keep;
    const bool valid0 = mrow[g0] != 0, valid1 = mrow[g0 + 8] != 0;
    float acc[2][32];  // dV (S side) or dK (dP side), head columns 64 (hb + h) ..
    zero_acc(acc);
    if (!s_side) {  // both exchange buffers start empty
      named_arrive(3);
      named_arrive(4);
    }
    const uint32_t kvt = base + (s_side ? L_::kK : L_::kV);

    // S^T (S side) or dP^T (dP side) of the query tile in stage s: K or V
    // against Q or dO, issued
    auto issue_x = [&](float (&sc)[QT / 2], int s) {
      const uint32_t ad = opaque(desc_lo(kvt));
      const uint32_t bd = opaque(desc_lo(stage(s) + (s_side ? 0 : kTileQ)));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<QT>(sc, kmajor(ad, 64, 0, kk), kmajor(bd, QT, 0, kk), kk > 0);
    };
    // query tile t (stage s): P^T (S side, which also hands P and the keep
    // bits across) or dS^T (dP side) into bf16 A fragments
    auto form = [&](const float (&sc)[QT / 2], int t, int s, uint32_t (&fr)[QT / 16][4]) {
      const float* lse = reinterpret_cast<const float*>(smem + L_::kStage0 +
                                                        s * L_::kStageBytes + 2 * kTileQ);
      const float* dsum = lse + QT;
      const int x = t & 1;
      float* xp = reinterpret_cast<float*>(smem + L_::kX0 + x * L_::kXBytes);
      unsigned* xbits = reinterpret_cast<unsigned*>(xp + 64 * QT);
      if (s_side) {
        named_sync(3 + x);  // the dP side is done with this buffer
        unsigned bits = 0;
#pragma unroll
        for (int j = 0; j < QT / 8; ++j) {
          const int qc = 8 * j + L.c2;
          const float2 ls = *reinterpret_cast<const float2*>(lse + qc);
          const unsigned qh0 = static_cast<unsigned>(t * QT + qc) * 2654435761u;
          const unsigned qh1 = static_cast<unsigned>(t * QT + qc + 1) * 2654435761u;
          float pd[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool valid = e < 2 ? valid0 : valid1;
            const float pv = __expf((valid ? sc[4 * j + e] * scale : mval) - ((e & 1) ? ls.y : ls.x));
            xp[(4 * j + e) * 128 + tid] = pv;
            pd[e] = pv;
            if (drop) {
              const unsigned hx = ((e & 1) ? qh1 : qh0) ^ (e < 2 ? kh0 : kh1);
              const bool keep = lfs2::fmix(hx + sbh) >= thr;
              bits |= static_cast<unsigned>(keep) << (4 * j + e);
              pd[e] = keep ? pv * inv_keep : 0.0f;
            }
          }
          fr[j >> 1][(j & 1) * 2] = pack_bf16(pd[0], pd[1]);
          fr[j >> 1][(j & 1) * 2 + 1] = pack_bf16(pd[2], pd[3]);
        }
        xbits[tid] = bits;
        named_arrive(1 + x);
      } else {
        named_sync(1 + x);  // the S side has filled this buffer
        const unsigned bits = xbits[tid];
#pragma unroll
        for (int j = 0; j < QT / 8; ++j) {
          const float2 dd = *reinterpret_cast<const float2*>(dsum + 8 * j + L.c2);
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool valid = e < 2 ? valid0 : valid1;
            const float pv = xp[(4 * j + e) * 128 + tid];
            float dpv = sc[4 * j + e];
            if (drop) dpv = (bits >> (4 * j + e)) & 1u ? dpv * inv_keep : 0.0f;
            ds[e] = valid ? pv * (dpv - ((e & 1) ? dd.y : dd.x)) * scale : 0.0f;
          }
          fr[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
          fr[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
        named_arrive(3 + x);
      }
    };

    // dV += P^T.dO (S side) or dK += dS^T.Q (dP side) of the tile in
    // stage s, committed
    auto issue_acc = [&](const uint32_t (&fr)[QT / 16][4], int s) {
      const uint32_t bd = opaque(desc_lo(stage(s) + (s_side ? kTileQ : 0)));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          wgmma_rs_n64_t(acc[hh], fr[kk], mnmajor(bd, QT, hb + hh, kk));
      wgmma_commit();
    };

    float sc[QT / 2];
    uint32_t fr[QT / 16][4];
    mbar_wait(kvbar, 0);
    mbar_wait(bars, 0);
    issue_x(sc, 0);
    wgmma_commit();
    wgmma_wait<0>();
    hold(sc);
    form(sc, 0, 0, fr);
    int t = 0;
    for (; t + 1 < nt; ++t) {  // all but the last query tile
      const int s = t % kStages, s1 = (t + 1) % kStages;
      mbar_wait(bars + 8 * s1, ((t + 1) / kStages) & 1);
      issue_x(sc, s1);  // the next tile's S^T or dP^T first ...
      wgmma_commit();
      issue_acc(fr, s);  // ... then this one's dV or dK product
      uint32_t fn[QT / 16][4];
      wgmma_wait<1>();  // the next tile's per-score work while it runs
      hold(sc);
      form(sc, t + 1, s1, fn);
      wgmma_wait<0>();
      hold_acc(acc);
      hold(fr);
      if (L.lane == 0) mbar_arrive(bars + 8 * (kStages + s));
      copy_frags(fr, fn);
    }
    issue_acc(fr, t % kStages);  // the last tile's
    wgmma_wait<0>();
    hold_acc(acc);
    if (L.lane == 0) mbar_arrive(bars + 8 * (kStages + t % kStages));
    store_rows<D>((s_side ? p.dv : p.dk) + (static_cast<size_t>(bh_row) + g0) * D, acc, 64 * hb,
                  L.c2, 1.0f, 1.0f);
  }
}

// ---- host: tensor maps, launches ---------------------------------------------
// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: it is taken
// through the runtime's entry-point query, so the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status) ==
            cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a (rows, d) bf16 slab read in boxes of box_rows x 64 columns, 128-byte swizzle
bool make_map(CUtensorMap* map, const void* ptr, int rows, int box_rows, int d) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estrides[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
             estrides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

bool shape_ok(int B, int H, int T_len, int d) {
  return B >= 1 && H >= 1 && B <= 65535 && H <= 65535 && T_len >= 128 && T_len % 128 == 0 &&
         T_len <= 32 * kMaxTiles && (d == 128 || d == 256);
}

// A kernel's shared memory: its layout's bytes and room to align the base
// to 1024 bytes. Setting it is a runtime call, made before the tensor maps:
// it makes the device's context current on the calling thread, which the
// driver's tensor-map encoder needs (a thread on which nothing has run CUDA
// work yet, such as autograd's device thread before its first kernel, has
// none, and the encoder fails there).
template <typename K> cudaError_t prepare(K kernel, int bytes) {
  return lfs2::allow_smem(kernel, bytes + 1024);
}

// grid (blocks_x, H, B), after prepare()
template <typename K, typename... Args>
cudaError_t launch(K kernel, int blocks_x, int bytes, int B, int H, cudaStream_t s,
                   Args... args) {
  kernel<<<dim3(blocks_x, H, B), kThreads, bytes + 1024, s>>>(args...);
  return cudaGetLastError();
}

template <int D>
cudaError_t fwd_launch(const void* q, const void* k, const void* v, const Params& p, int B,
                       cudaStream_t s) {
  const int rows = B * p.H * p.T;
  constexpr int KT = FwdLayout<D>::kKT, QR = FwdLayout<D>::kQRows;
  const cudaError_t err = prepare(fwd_sm90_kernel<D>, FwdLayout<D>::kBytes);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, rows, QR, D) || !make_map(&tk, k, rows, KT, D) ||
      !make_map(&tv, v, rows, KT, D))
    return cudaErrorNotSupported;
  return launch(fwd_sm90_kernel<D>, p.T / QR, FwdLayout<D>::kBytes, B, p.H, s, tq, tk, tv, p);
}

template <int D>
cudaError_t bwd_launch(const void* q, const void* k, const void* v, const void* dout,
                       const Params& p, int B, cudaStream_t s) {
  const int rows = B * p.H * p.T;
  constexpr int KT = DqLayout<D>::kKT, QR = DqLayout<D>::kQRows, QT = DkvLayout<D>::kQT;
  cudaError_t err = prepare(dq_sm90_kernel<D>, DqLayout<D>::kBytes);
  if (err == cudaSuccess) err = prepare(dkv_sm90_kernel<D>, DkvLayout<D>::kBytes);
  if (err != cudaSuccess) return err;
  CUtensorMap tq128, tdo128, tkq, tvq, tk64, tv64, tqq, tdoq;
  if (!make_map(&tq128, q, rows, QR, D) || !make_map(&tdo128, dout, rows, QR, D) ||
      !make_map(&tkq, k, rows, KT, D) || !make_map(&tvq, v, rows, KT, D) ||
      !make_map(&tk64, k, rows, 64, D) || !make_map(&tv64, v, rows, 64, D) ||
      !make_map(&tqq, q, rows, QT, D) || !make_map(&tdoq, dout, rows, QT, D))
    return cudaErrorNotSupported;
  err = launch(dq_sm90_kernel<D>, p.T / QR, DqLayout<D>::kBytes, B, p.H, s, tq128, tdo128, tkq,
               tvq, p);
  if (err != cudaSuccess) return err;
  return launch(dkv_sm90_kernel<D>, p.T / 64 * DkvLayout<D>::kHalves, DkvLayout<D>::kBytes, B,
                p.H, s, tk64, tv64, tqq, tdoq, p);
}

}  // namespace

LFS2_DEFINE_ERROR_STRING

// bf16 q, k, v (B, H, T, d), d = 128 or 256; o bf16, o32 (the same before
// its rounding, f32, for the backward's D) and lse (B, H, T) f32 are
// written; mask (B, T) int32; seed is one int32 on the device
LFS2_EXPORT int lfs2_flash_attention_sm90_fwd(const void* q, const void* k, const void* v,
                                              const int* mask, const int* seed, void* o,
                                              float* lse, float* o32, int B, int H, int T_len,
                                              int d, float scale, unsigned threshold,
                                              float inv_keep, void* stream) {
  if (!shape_ok(B, H, T_len, d) || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(mask) || !aligned16(o32))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{mask, seed, nullptr, nullptr, static_cast<__nv_bfloat16*>(o), o32, nullptr,
                 nullptr, lse, nullptr, H, T_len, scale, threshold, inv_keep};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(d == 128 ? fwd_launch<128>(q, k, v, p, B, s)
                                   : fwd_launch<256>(q, k, v, p, B, s));
}

// the dQ pass (which also writes dsum, (B, H, T) f32 scratch), then the
// K-major dK/dV pass, on one stream; o32 and lse are the forward's
LFS2_EXPORT int lfs2_flash_attention_sm90_bwd(const void* q, const void* k, const void* v,
                                              const int* mask, const int* seed, const void* o32,
                                              const float* lse, const void* dout, void* dq,
                                              void* dk, void* dv, float* dsum, int B, int H,
                                              int T_len, int d, float scale, unsigned threshold,
                                              float inv_keep, void* stream) {
  if (!shape_ok(B, H, T_len, d) || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(dout) || !aligned16(o32) || !aligned16(lse) || !aligned16(dsum) ||
      !aligned16(mask) || !aligned16(dk) || !aligned16(dv))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{mask, seed, static_cast<const float*>(o32),
                 static_cast<const __nv_bfloat16*>(dout), static_cast<__nv_bfloat16*>(dq), nullptr,
                 static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
                 const_cast<float*>(lse), dsum, H, T_len, scale, threshold, inv_keep};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(d == 128 ? bwd_launch<128>(q, k, v, dout, p, B, s)
                                   : bwd_launch<256>(q, k, v, dout, p, B, s));
}

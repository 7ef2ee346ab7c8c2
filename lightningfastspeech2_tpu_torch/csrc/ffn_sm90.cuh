// ffn_sm90.cuh: what the two FFN sources' tensor-core routes share: the
// geometry tables (bf16 wgmma, f32 split-TF32 mma.sync), mbarriers and bulk
// copies, the wgmma products, the 128-byte swizzle, the f32 route's
// products from shared memory, and the reductions on the accumulator
// layout.
//
// Geometry (ops/ffn.py ffn_plan mirrors this table; the static_asserts
// below hold it to a block's shared memory):
//   kRows   rows of one batch item a block of the wgmma kernels owns: two
//           warpgroups of 64 rows and nothing else. Registers are handed
//           out per SM quarter, so with two warps a quarter a thread may
//           hold 255: a 64 x 256 f32 accumulator beside a chunk's 64 x 64
//           with the wgmma kept asynchronous. (A producer warpgroup would
//           leave 240 after setmaxnreg, and ptxas then serialises every
//           wgmma at C = 256.) The last warp to release a weight buffer
//           issues its next chunk.
//   kFC     F columns per weight chunk
//   CP      channels as the tiles hold them: C, or 64 for C = 32 (zeros
//           beyond C, so every product is exact)
// A weight chunk is two CP x 64 bf16 matrices, each CP * 128 bytes, both
// pre-swizzled by ops/ffn.py _weight_image so one bulk copy moves each:
//   W1 chunk  W1[:, f0:f0+64] as CP rows of 128 bytes: the up product's B
//             (MN-major: N = f along the row) and, through the transpose
//             bit, dacc's B (K-major: K = f along the row)
//   W2 chunk  W2f[f0:f0+64, :] as CP/64 boxes of 64 rows (f) x 128 bytes
//             (64 channels): ff's B (MN-major, boxes LBO apart) and dup's
//             B (K-major, K = c across the boxes)
// Activation tiles (h0, dff) are kRows x CP in CP/64 boxes of kRows rows x
// 128 bytes, the same swizzle: the A of a product (K-major) or, transposed,
// the A or B of a weight-gradient product (MN-major, K = rows).
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace ffn {

using bf16 = __nv_bfloat16;

constexpr int kRows = 128;
constexpr int kFC = 64;
constexpr int kThreads = 256;     // two warpgroups
constexpr int kDt1Rows = 64;      // rows a depthwise/LN1-backward block owns
constexpr int kDt1Threads = 256;
constexpr int kMaxK = 63;         // the depthwise widths the training kernels take
constexpr int kBarBytes = 64;
constexpr int kMaxSmem = 232448;  // a block's shared memory on an H100

__host__ __device__ constexpr int wbuf_bytes(int CP) { return CP * 128; }
__host__ __device__ constexpr int tile_bytes(int CP) { return kRows * CP * 2; }
__host__ __device__ constexpr int stage_bytes() { return kRows * kFC * 2; }
// the forward's window: t1 over the rows and their k - 1 halo during the
// prologue, then the up chunk staged for the ff product
__host__ __device__ constexpr int window_bytes(int CP, int k) {
  return (kRows + k - 1) * CP * 2 > stage_bytes() ? (kRows + k - 1) * CP * 2 : stage_bytes();
}
// forward / backward chain: two weight buffers (wd during the prologue), h0,
// the window, each window row's LN1 mean and 1 / sigma, barriers (and the
// 1 KB that aligns the swizzled buffers)
__host__ __device__ constexpr int fwd_smem(int CP, int k) {
  return 1024 + 2 * wbuf_bytes(CP) + tile_bytes(CP) + window_bytes(CP, k) + (kRows + k - 1) * 8 +
         kBarBytes;
}
// dup pass: two weight buffers, h0 and dff, the up and dup chunks
__host__ __device__ constexpr int dup_smem(int CP) {
  return 1024 + 2 * wbuf_bytes(CP) + 2 * tile_bytes(CP) + 2 * stage_bytes() + kBarBytes;
}
// depthwise/LN1 backward: dacc (f32) and t1 (the working dtype, `elem`
// bytes) over the rows and k - 1
__host__ __device__ constexpr int dt1_smem(int C, int k, int elem) {
  return (kDt1Rows + k - 1) * C * (4 + elem);
}

static_assert(fwd_smem(256, kMaxK) <= kMaxSmem, "forward tile");
// the forward's epilogue row buffer (kRows x (CP + 4) f32) over the weight
// buffers, h0 and the window, at the smallest window (k = 1)
static_assert(kRows * (256 + 4) * 4 <= 2 * wbuf_bytes(256) + tile_bytes(256) + window_bytes(256, 1) &&
                  kRows * (64 + 4) * 4 <= 2 * wbuf_bytes(64) + tile_bytes(64) + window_bytes(64, 1),
              "row buffer");
static_assert(kMaxK * 256 * 4 <= 2 * wbuf_bytes(256) && kMaxK * 64 * 4 <= 2 * wbuf_bytes(64),
              "wd fits the weight buffers during the prologue");
static_assert(dup_smem(256) <= kMaxSmem, "dup tile");
static_assert(dt1_smem(256, kMaxK, 2) <= kMaxSmem, "dt1 tile");
static_assert(kRows == 2 * 64 && kThreads == 2 * 128 && kFC == 64, "two warpgroups");
static_assert(kDt1Rows % (kDt1Threads / 32) == 0, "dt1 rows a warp");

// byte offset of element (r, c) of a tile of `rows` rows in 64-column boxes
__device__ __forceinline__ int swz(int r, int c, int rows) {
  return (c >> 6) * rows * 128 + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// ---- phase clocks (built with LFS2_FFN_PHASE_CLOCKS only) --------------------
// Block (0, 0)'s two warpgroups add the cycles of each phase in shared
// memory and, at the end, into g_phase[warpgroup][slot];
// lfs2_ffn_*_phase_clocks copies them out.
#ifdef LFS2_FFN_PHASE_CLOCKS
__device__ long long g_phase[2][16];
#define FFN_CLOCK(var)                                                             \
  long long var = clock64();                                                       \
  __shared__ long long ffn_phase_[2][16];                                          \
  if (threadIdx.x < 32) ffn_phase_[threadIdx.x >> 4][threadIdx.x & 15] = 0
#define FFN_PHASE(slot, since)                                                     \
  do {                                                                             \
    if (blockIdx.x == 0 && blockIdx.y == 0 && (threadIdx.x & 127) == 0) {          \
      const long long now_ = clock64();                                            \
      ffn_phase_[threadIdx.x >> 7][slot] += now_ - since;                          \
      since = now_;                                                                \
    }                                                                              \
  } while (0)
#define FFN_FLUSH()                                                                \
  do {                                                                             \
    if (blockIdx.x == 0 && blockIdx.y == 0 && (threadIdx.x & 127) == 0)            \
      for (int i_ = 0; i_ < 16; ++i_)                                              \
        ffn::g_phase[threadIdx.x >> 7][i_] += ffn_phase_[threadIdx.x >> 7][i_];    \
  } while (0)
#else
#define FFN_CLOCK(var)
#define FFN_PHASE(slot, since)
#define FFN_FLUSH()
#endif

// ---- shared memory, mbarriers, bulk copies ---------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
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
// contiguous bytes (16-byte aligned, a multiple of 16) into shared memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, unsigned bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Per weight buffer: an mbarrier that completes when its chunk has landed,
// and a count of the warps that released it; the eighth warp to release
// chunk i issues chunk i + 1 into the buffer.
struct Bars {
  uint32_t full1, full2;
  uint32_t* released;  // [2]: W1, W2 buffer
  __device__ __forceinline__ Bars(uint32_t at, uint32_t* counts)
      : full1(at), full2(at + 8), released(counts) {}
  __device__ __forceinline__ void init() const {
    mbar_init(full1, 1);
    mbar_init(full2, 1);
    released[0] = released[1] = 0u;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// `bytes` from src into the buffer barrier m (0: full1, 1: full2) guards
__device__ __forceinline__ void load_bytes(const Bars& bars, int m, uint32_t dst, const void* src,
                                           int bytes) {
  const uint32_t full = m == 0 ? bars.full1 : bars.full2;
  mbar_expect_tx(full, bytes);
  bulk_load(dst, src, bytes, full);
}
// chunk ci's W1 (m = 0) or W2 (m = 1) matrix from the weight image into its
// buffer
__device__ __forceinline__ void load_w(const Bars& bars, int m, uint32_t dst, const uint8_t* img,
                                       int ci, int CP) {
  load_bytes(bars, m, dst, img + (static_cast<size_t>(ci) * 2 + m) * wbuf_bytes(CP), wbuf_bytes(CP));
}
// A warp is done reading buffer m's chunk (after its wgmma_wait): lane 0
// counts the release, and the last of the eight warps issues chunk next
// (none when next < 0)
__device__ __forceinline__ void release_w(const Bars& bars, int m, uint32_t dst,
                                          const uint8_t* img, int next, int CP) {
  if ((threadIdx.x & 31) == 0 && (atomicAdd(&bars.released[m], 1u) & 7u) == 7u && next >= 0)
    load_w(bars, m, dst, img, next, CP);
}

// ---- wgmma ------------------------------------------------------------------
// Descriptors: a low word (start address >> 4, leading byte offset >> 4)
// and the high word kDescHi (stride byte offset 1024, the stride of 8-row
// groups, and the 128-byte swizzle). K-major operands ignore the leading
// offset; MN-major ones take it as the stride between 64-element boxes.
constexpr uint32_t kDescHi = (1024u >> 4) | (1u << 30);

__device__ __forceinline__ uint32_t desc(uint32_t addr, uint32_t lbo = 1024u) {
  return ((addr & 0x3FFFFu) >> 4) | ((lbo >> 4) << 16);
}
// x, opaque to the compiler: descriptors derived from it inside a loop are
// recomputed there (one add each) instead of hoisted into dozens of live
// registers beside the accumulators
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(x));
  return x;
}
// k-step kk (16 columns) of a K-major tile of `rows` rows in 64-column
// boxes, from row `row0`
__device__ __forceinline__ uint32_t kmajor(uint32_t d, int rows, int row0, int kk) {
  return d + (((kk >> 2) * rows * 128 + row0 * 128 + (kk & 3) * 32) >> 4);
}
// k-step kk (16 rows) of an MN-major operand
__device__ __forceinline__ uint32_t mnmajor(uint32_t d, int kk) { return d + ((kk * 2048) >> 4); }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Registers an in-flight wgmma reads or writes, pinned after the wait that
// retires it, so that the compiler neither reuses nor reads them before
template <int N> __device__ __forceinline__ void hold(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
// named barriers among the block's 256 threads (id 0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
// a named barrier among one warpgroup's 128 threads
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// d (64 x N) (+)= A (smem) * B (smem), N = 32, 64, 128 or 256; TA / TB: the
// operands' transpose bits (1: MN-major, boxes the descriptor's leading
// offset apart); scale_d 0 overwrites d
template <int N> struct SsOp;
template <> struct SsOp<32> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float (&d)[16], uint32_t da, uint32_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %19, 0;\n"
        "mov.b64 da, {%16, %18};\nmov.b64 db, {%17, %18};\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, da, db, p, 1, 1, %20, %21;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(da), "r"(db), "r"(kDescHi), "r"(scale_d), "n"(TA), "n"(TB));
  }
};
template <> struct SsOp<64> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float (&d)[32], uint32_t da, uint32_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %35, 0;\n"
        "mov.b64 da, {%32, %34};\nmov.b64 db, {%33, %34};\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, da, db, p, 1, 1, %36, %37;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(da), "r"(db), "r"(kDescHi), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <> struct SsOp<128> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float (&d)[64], uint32_t da, uint32_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %67, 0;\n"
        "mov.b64 da, {%64, %66};\nmov.b64 db, {%65, %66};\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, da, db, p, 1, 1, %68, %69;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(da), "r"(db), "r"(kDescHi), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <> struct SsOp<256> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float (&d)[128], uint32_t da, uint32_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %131, 0;\n"
        "mov.b64 da, {%128, %130};\nmov.b64 db, {%129, %130};\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, da, db, p, 1, 1, %132, %133;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(da), "r"(db), "r"(kDescHi), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

// ---- the accumulator layout ---------------------------------------------------
// A thread of an m64nN accumulator holds rows r and r + 8 of its
// warp's 16 (r = lane / 4) and, of every 8-column block j, columns
// 8 j + 2 (lane % 4) and + 1: acc[4 j + e], e = 0, 1 row r, e = 2, 3 row r + 8.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// Sums x, y (a thread's two rows of columns c, c + 1) over the warp's 16
// rows (the eight lanes of equal lane % 4) and adds them into dst[c], dst[c
// + 1] (a zeroed f32 buffer) from the lanes of the first row; all lanes
// call it
__device__ __forceinline__ void add_col_pair(float* dst, float x, float y, int lane) {
#pragma unroll
  for (int m = 4; m < 32; m <<= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, m);
    y += __shfl_xor_sync(0xffffffffu, y, m);
  }
  if (lane < 4) atomicAdd(reinterpret_cast<float2*>(dst), make_float2(x, y));
}
// one 128-row tile's pair of columns c, c + 1 of row r as bf16, rounded
__device__ __forceinline__ void stage_pair(uint8_t* tile, int r, int c, float x, float y) {
  *reinterpret_cast<uint32_t*>(tile + swz(r, c, kRows)) = pack_bf16(x, y);
}
// LayerNorm of one value from its row's mean and 1 / sigma, as every LN1
// and LN2 of the FFN kernels forms it
__device__ __forceinline__ float ln_apply(float v, float mean, float inv, float g, float b) {
  return (v - mean) * inv * g + b;
}
// A 64 x 64 weight-gradient accumulator added into a row-major f32 matrix
// of `ld` columns: row m0 + r (r, r + 8 of the warp's 16), column n0 +
// 8 j + c2; lanes of a pair swap halves so each adds four consecutive
// columns of one row with one vector reduction. Rows >= mlim or columns
// >= nlim are not added.
__device__ __forceinline__ void add_tile(float* dst, int ld, const float (&acc)[32], int m0,
                                         int n0, int lane, int mlim, int nlim) {
  const int r = m0 + 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
  const bool odd = lane & 1;
  const int row = odd ? r + 8 : r;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float x = __shfl_xor_sync(0xffffffffu, odd ? acc[4 * j] : acc[4 * j + 2], 1);
    const float y = __shfl_xor_sync(0xffffffffu, odd ? acc[4 * j + 1] : acc[4 * j + 3], 1);
    const float4 v = odd ? make_float4(x, y, acc[4 * j + 2], acc[4 * j + 3])
                         : make_float4(acc[4 * j], acc[4 * j + 1], x, y);
    const int col = n0 + 8 * j + 2 * ((lane & 3) & ~1);
#ifndef LFS2_FFN_NO_WGRAD_ATOMICS  // defined only to time the products without the reductions
    if (row < mlim && col < nlim)
      atomicAdd(reinterpret_cast<float4*>(dst + static_cast<size_t>(row) * ld + col), v);
#else
    (void)v;
#endif
  }
}

// the keep test (lfs2::ffn_keep) with the row's factor g * 2654435761
// hoisted: rh for the row, ch = c + 0x9E3779B9 * salt for the column
__device__ __forceinline__ bool keep_h(unsigned rh, unsigned ch, unsigned seed_b, unsigned thr) {
  return lfs2::fmix((rh ^ ch) + seed_b) >= thr;
}
__device__ __forceinline__ unsigned row_hash(int g) {
  return static_cast<unsigned>(g) * 2654435761u;
}
__device__ __forceinline__ unsigned col_hash(int c, unsigned salt) {
  return static_cast<unsigned>(c) + 0x9E3779B9u * salt;
}

// ============ f32 route: split TF32 on mma.sync (m16n8k8) =====================
// Geometry (ops/ffn.py ffn_plan mirrors this table too):
//   R        rows of one batch item a block owns, 64 or 32 (the plan takes
//            the one that fills more of the card), eight warps
//   kF32FC   F columns per chunk of the forward and the backward's chain: a
//            W1 piece (K = C, N = 32) and a W2f piece (K = 32, N = C)
//   kDupFC   F columns per chunk of the dup pass: W1 (K = C, N = 16), W2f^T
//            (K = C, N = 16) and W1^T (K = 16, N = C) pieces
// A piece is a K x N product operand split into TF32 hi and lo halves in
// mma.sync's B-fragment order (ops/ffn.py _frag_order), K N 8 bytes: per
// k-step of 8 and n8 tile, 32 lanes of one float4 (hi of the k-step's rows
// 2t and 2t + 1 at column g, then lo). Within every k-step the product's k
// indices t and t + 4 are the operands' rows (columns of A) 2t and 2t + 1,
// so an A fragment is two float2 reads of a row-major tile, and the
// accumulator of one n8 tile is, as it stands, the A fragment of the next
// product's k-step. Activation tiles are f32 rows of C in shared memory,
// columns swizzled by swz32. The tensor cores' f32 accumulation truncates,
// so every product sums a run of at most 64 k indices from zero and adds
// it to the running sum with f32 adds.
constexpr int kF32FC = 32;
constexpr int kDupFC = 16;
constexpr int kStageLd = kDupFC + 4;  // row stride (floats) of the dup pass's plain stagings
constexpr int kMaxKF32 = 50;          // the f32 dt1 tile at C = 256
__host__ __device__ constexpr int piece_bytes(int C, int fc) { return C * fc * 8; }
// forward / chain: the W1 and W2f pieces (the t1 window during the
// prologue, the row buffer in the epilogue), h0, two up chunks as the ff
// product's split A fragments, barriers, each window row's LN1 statistics
__host__ __device__ constexpr int f32_fwd_smem(int R, int C, int k) {
  return 2 * piece_bytes(C, kF32FC) + R * C * 4 + 2 * R * kF32FC * 8 + kBarBytes + (R + k - 1) * 8;
}
// dup pass: two piece buffers, h0 and dff, dup as dacc's split A
// fragments, dup and up_d split in plain rows (hi, lo each), the dup_d
// hand-over, barriers
__host__ __device__ constexpr int f32_dup_smem(int R, int C) {
  return 2 * piece_bytes(C, kDupFC) + 2 * R * C * 4 + R * kDupFC * 8 + 4 * R * kStageLd * 4 +
         R * kDupFC * 4 + kBarBytes;
}
static_assert(f32_fwd_smem(64, 256, kMaxKF32) <= kMaxSmem, "f32 forward tile");
static_assert((64 + kMaxKF32 - 1) * 4 <= 2 * kF32FC * 8 && 64 * (256 + 4) * 4 <= 2 * piece_bytes(256, kF32FC),
              "the t1 window and the row buffer fit the f32 pieces' buffers");
static_assert(f32_dup_smem(64, 256) <= kMaxSmem, "f32 dup tile");
static_assert(dt1_smem(256, kMaxKF32, 4) <= kMaxSmem, "f32 dt1 tile");

// column of element (r, c) in an f32 tile: bits 3-4 of c flipped by a
// function of r % 8 that is one to one on rows {0-3}, {4-7}, {0, 2, 4, 6}
// and {1, 3, 5, 7}, so both of a fragment's reads meet 32 banks: row-wise
// float2 (rows g, columns 2t) and transposed scalars (rows 2t + e, column g)
__device__ __forceinline__ int swz32(int r, int c) {
  return c ^ ((((r ^ (r >> 2)) & 1) | (r & 2)) << 3);
}

// A warp is done with a buffer: lane 0 counts it on *count (after the
// warp's lanes converge), and is told whether its warp completed a round
// of n; that warp issues the buffer's next load
__device__ __forceinline__ bool last_of(uint32_t* count, unsigned n) {
  __syncwarp();
  return (threadIdx.x & 31) == 0 && atomicAdd(count, 1u) % n == n - 1;
}

// acc (NT n8 tiles of 16 rows) = rows [r0, r0 + 16) of the f32 tile src
// (C columns, swizzled) times n8 tiles [j0, j0 + NT) of a piece with K = C
// and NTOT n8 tiles. The three terms of a k-step go to three sets of
// accumulators (independent chains on the tensor cores), each summed from
// zero over 64 k indices and added in f32.
template <int C, int NT, int NTOT>
__device__ __forceinline__ void rows_x_piece(float (&acc)[NT][4], const float* src, int r0,
                                             const float4* piece, int j0, int lane) {
  constexpr int KR = C < 64 ? C : 64;
  const int g = lane >> 2, t = lane & 3;
  const float* x0 = src + (r0 + g) * C;
  const float* x1 = src + (r0 + g + 8) * C;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll 1
  for (int kb = 0; kb < C; kb += KR) {
    float tc[3][NT][4];
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) tc[q][nt][e] = 0.0f;
#pragma unroll 4
    for (int s = kb / 8; s < (kb + KR) / 8; ++s) {
      const float2 a0 = *reinterpret_cast<const float2*>(x0 + swz32(r0 + g, 8 * s + 2 * t));
      const float2 a1 = *reinterpret_cast<const float2*>(x1 + swz32(r0 + g + 8, 8 * s + 2 * t));
      uint32_t ah[4], al[4];
      lfs2::split_a(a0.x, a1.x, a0.y, a1.y, ah, al);
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) lfs2::frag_b(piece[(s * NTOT + j0 + nt) * 32 + lane], bh[nt], bl[nt]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) lfs2::mma_tf32(tc[0][nt], ah, bl[nt]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) lfs2::mma_tf32(tc[1][nt], al, bh[nt]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) lfs2::mma_tf32(tc[2][nt], ah, bh[nt]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += (tc[0][nt][e] + tc[1][nt][e]) + tc[2][nt][e];
  }
}

// acc (MT m16 x NT n8 tiles) += KS k-steps of A fragments stored split in
// fragment order (per k-step and m16 tile, 32 lanes of a hi and a lo
// float4; MTOT m16 tiles a k-step) from m16 tile m0, times n8 tiles [j0,
// j0 + NT) of a piece with NTOT n8 tiles; summed from zero, added in f32
template <int MT, int NT, int KS, int MTOT, int NTOT>
__device__ __forceinline__ void frags_x_piece(float (&acc)[MT][NT][4], const float4* af, int m0,
                                              const float4* piece, int j0, int lane) {
  float tc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) tc[mt][nt][e] = 0.0f;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float4* p = af + ((s * MTOT + m0 + mt) * 32 + lane) * 2;
      const float4 h = p[0], l = p[1];
      ah[mt][0] = __float_as_uint(h.x), ah[mt][1] = __float_as_uint(h.y);
      ah[mt][2] = __float_as_uint(h.z), ah[mt][3] = __float_as_uint(h.w);
      al[mt][0] = __float_as_uint(l.x), al[mt][1] = __float_as_uint(l.y);
      al[mt][2] = __float_as_uint(l.z), al[mt][3] = __float_as_uint(l.w);
    }
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) lfs2::frag_b(piece[(s * NTOT + j0 + nt) * 32 + lane], bh[nt], bl[nt]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) lfs2::mma_tf32(tc[mt][nt], ah[mt], bl[nt]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) lfs2::mma_tf32(tc[mt][nt], al[mt], bh[nt]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) lfs2::mma_tf32(tc[mt][nt], ah[mt], bh[nt]);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] += tc[mt][nt][e];
}

// four values of an accumulator tile (rows g, g + 8; columns 2t, 2t + 1)
// as the split A fragment of the next product's k-step (k indices t, t + 4
// are columns 2t, 2t + 1): a hi and a lo float4 at dst[0], dst[1]
__device__ __forceinline__ void store_a_frag(float4* dst, const float (&v)[4]) {
  uint32_t h[4], l[4];
  lfs2::split_a(v[0], v[2], v[1], v[3], h, l);
  dst[0] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                       __uint_as_float(h[3]));
  dst[1] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                       __uint_as_float(l[3]));
}

// One m16n8 accumulator tile added into a row-major f32 matrix of `ld`
// columns at (row0, col0): lanes of a pair swap halves so each adds four
// consecutive columns of one row with one vector reduction
__device__ __forceinline__ void red_tile(float* dst, int ld, const float (&acc)[4], int row0,
                                         int col0, int lane) {
  const bool odd = lane & 1;
  const float x = __shfl_xor_sync(0xffffffffu, odd ? acc[0] : acc[2], 1);
  const float y = __shfl_xor_sync(0xffffffffu, odd ? acc[1] : acc[3], 1);
  const float4 v = odd ? make_float4(x, y, acc[2], acc[3]) : make_float4(acc[0], acc[1], x, y);
  const int row = row0 + (lane >> 2) + (odd ? 8 : 0);
  const int col = col0 + 2 * ((lane & 3) & ~1);
#ifndef LFS2_FFN_NO_WGRAD_ATOMICS  // defined only to time the products without the reductions
  atomicAdd(reinterpret_cast<float4*>(dst + static_cast<size_t>(row) * ld + col), v);
#else
  (void)v, (void)row, (void)col;
#endif
}

}  // namespace ffn

// Tensor-core and asynchronous-copy primitives of the mma.sync kernels
// (csrc/resblock.cu, csrc/flash_attention.cu, csrc/lvc_stack.cu and the f32
// routes of csrc/ffn_ln.cu and csrc/ffn_ln_train_bwd.cu): cp.async,
// ldmatrix, mma.sync in bf16 (m16n8k16) and in TF32 (m16n8k8), the
// split-TF32 product that keeps f32's digits on the tensor cores, and
// mbarriers with bulk copies.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace lfs2 {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ---- cp.async ---------------------------------------------------------------
// 16 bytes from device memory into shared memory, asynchronously (both
// addresses 16-byte aligned)
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  cp_async16(smem_u32(dst), src);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

// ---- ldmatrix ---------------------------------------------------------------
// Four 8 x 8 b16 matrices, one row address (16 bytes) per lane: lanes 8j to
// 8j + 7 give matrix j's rows, and register j of lane t holds row t / 4,
// columns 2 (t % 4) and + 1 of matrix j (with .trans, of its transpose).
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// ---- mma.sync ---------------------------------------------------------------
// c (16 x 8, f32) += a (16 x 16) b (16 x 8), bf16 operands. With g = lane / 4
// and t = lane % 4: a = {(g, 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8,
// 2t + 8..)} as packed pairs, b = {(2t.., g), (2t + 8.., g)}, c = {(g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- split-TF32 products ----------------------------------------------------
// One TF32 product keeps 11 bits of each operand. Split, x = hi + lo with
// hi = tf32(x) and lo = tf32(x - hi) (cvt.rna), a b is formed as a_hi b_lo +
// a_lo b_hi + a_hi b_hi with f32 accumulation (CUTLASS's
// OpMultiplyAddFastF32); the dropped a_lo b_lo is below 2^-22 of a b.
__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float h = tf32(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32(x - h));
}

// c (16 x 8) += a (16 x 8) b (8 x 8), TF32 operands: a = {(g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4)}, b = {(t, g), (t + 4, g)}, c as mma_bf16's
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b as a split product: the two correction terms, then hi x hi
__device__ __forceinline__ void mma3(float c[4], const uint32_t ah[4], const uint32_t al[4],
                                     const uint32_t bh[2], const uint32_t bl[2]) {
  mma_tf32(c, ah, bl);
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bh);
}

// An A fragment from its four raw values (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4), split into hi and lo
__device__ __forceinline__ void split_a(float v0, float v1, float v2, float v3, uint32_t ah[4],
                                        uint32_t al[4]) {
  split(v0, ah[0], al[0]);
  split(v1, ah[1], al[1]);
  split(v2, ah[2], al[2]);
  split(v3, ah[3], al[3]);
}

// A B fragment's hi and lo halves from one float4 of a split operand in
// fragment order: hi of k rows t and t + 4 at column g, then lo
__device__ __forceinline__ void frag_b(const float4& v, uint32_t bh[2], uint32_t bl[2]) {
  bh[0] = __float_as_uint(v.x);
  bh[1] = __float_as_uint(v.y);
  bl[0] = __float_as_uint(v.z);
  bl[1] = __float_as_uint(v.w);
}

// ---- mbarriers and bulk copies ----------------------------------------------
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait for the phase of parity `parity` to complete. A wait that has not
// completed after 2^26 tries (seconds) traps: a fault, not a hung card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
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

// contiguous bytes (16-byte aligned, a multiple of 16) into shared memory,
// counted on the mbarrier's transaction bytes
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

}  // namespace lfs2

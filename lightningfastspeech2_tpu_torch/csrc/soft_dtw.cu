// soft_dtw: exact soft-DTW over a batch of (N, M) distance lattices, forward
// (the corner value, and the softmin weights every cell gives its three
// predecessors) and backward (the E-recurrence over those weights, giving
// g * dValue/dD).
//
// Replaces lightningfastspeech2_tpu/ops/pallas_soft_dtw.py
// soft_dtw_from_dist_pallas: _fwd_kernel (:81) and _bwd_kernel (:112),
// joined there by a custom VJP (:191-212) and here by an autograd Function
// (ops/soft_dtw.py _SoftDTW). The TPU kernels keep one lattice in VMEM,
// skewed so that an anti-diagonal is one vector row.
//
// What bounds them on the H100. The function's bytes (D in and one float a
// cell out; that float in and dD out) take ~0.01 ms a kernel at the mel
// loss's 64 lattices of 256 x 256, but each lattice is a chain of N + M - 1
// dependent anti-diagonals ("steps"), so the time is the chain's length
// times one step. The design keeps the step short (ops/soft_dtw.py soft_dtw_plan
// sizes every launch; scripts/bench_soft_dtw.py times it):
//
// * One block a lattice, every lattice of a call in one launch. A thread
//   owns K consecutive rows i0 .. i0 + K - 1 (i0 = K * threadIdx.x) and at
//   step s computes its K cells of anti-diagonal s, (i, s - i): they are
//   independent. A cell needs the row above at steps s - 1 and s - 2 and its
//   own row at s - 1: registers, one __shfl_up_sync (the last row of the
//   lane above), or, for lane 0 of warp w > 0, a ring in shared memory that
//   warp w - 1 fills a step at a time. A ring slot is one 64-bit word, the
//   value and its step, so the reader checks the step it finds and no fence
//   is needed; the reader reports how far it has read once a chunk of P
//   steps, and a ring holds four chunks. No block barrier after the first:
//   each warp runs up to a few chunks ahead of the one below, and walks only
//   the steps where its rows hold cells. The backward mirrors all of it
//   upwards.
// * Nothing global on the chain. The forward loads D(i, s + P - i) of each
//   row P steps before the step that uses it (a register ring indexed by
//   the unrolled step); the backward stages its weights in shared memory
//   with cp.async one chunk ahead (staging more gained nothing). No load is
//   consumed in the chunk that issues it.
// * The forward's softmin in base 2 with the minimum's term not computed:
//   m, mid and hi are the three inputs in order (five min / max), the
//   minimum's exp is exactly 1, so S = 1 + ex2((m - mid) c) + ex2((m - hi) c)
//   with c = log2(e) / gamma, and softmin = m - gamma ln2 lg2(S): two ex2 and
//   one lg2 a cell. R = D + softmin is formed as the plain recurrence forms
//   it (m - gamma log S, then + D), so R keeps the digits it has there.
// * The backward's chain holds no exp, log or division. The forward writes,
//   for every cell n, the weights its softmin gives its predecessors,
//   w_x(n) = exp((m_n - R_x) / gamma) / S_n, formed from n's own softmin
//   inputs (never as R_n - R_x - D_n, which loses digits where R ~ 1e4),
//   in each warp's band: W[l][w][t][x][r] is the weight of cell (i, s - i),
//   i = 32 K w + r, s = 32 K w + t, t < 32 K + M - 1 (the steps where the
//   warp's rows hold cells), x = up (i-1, j), left (i, j-1), diag
//   (i-1, j-1). Three floats a cell where the function needs one (R): the
//   price of a chain with no exp. The backward pushes: cell n holds E(n),
//   sends E(n) w_left(n) along its own row (a register), and E(n) w_up(n) +
//   E(n + (0, 1)) w_diag(n + (0, 1)) to the row above (a shuffle, or the
//   ring between warps): one add and one FMA a cell on the chain. The TPU
//   kernel clipped each weight's exponent to [-80, 30]; the exponent is
//   never positive (m is the minimum), and the clip below changes a weight
//   by at most exp(-80), so it is gone.
// * Stores leave coalesced. A step's weights go to a warp buffer in shared
//   memory, and a chunk's leave as one contiguous run of its band; a
//   chunk's dD goes to a warp buffer and leaves as runs of P columns of a
//   row (one row a lane would touch 32 cache lines a store).
//
// LFS2_SOFT_DTW_NO_MEMORY (a LFS2_KERNEL_DEFINES variant, for
// scripts/bench_soft_dtw.py --floor) builds the same chains with every
// global load and store but the last taken out: the chain's own floor.
#include "common.cuh"

namespace {

constexpr float kInf = 1e10f;  // ops/pallas_soft_dtw.py _INF
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 512;  // every instantiation: up to 128 registers a thread
constexpr int kMaxSmem = 232448;
constexpr int kRingChunks = 4;  // a hand-over ring holds this many chunks of P steps

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The hand-over between warps. A ring slot holds a value and the step it
// belongs to in one 64-bit word, so a reader that finds its step finds its
// value: no fence on either side. The reader publishes how far it has read
// (a plain int) only after it has used what it read, so the writer, which
// waits on that before it reuses a slot, needs no fence either.
__device__ __forceinline__ void put_slot(unsigned addr, float v, int step) {
  const unsigned long long x =
      (static_cast<unsigned long long>(static_cast<unsigned>(step)) << 32) | __float_as_uint(v);
  asm volatile("st.volatile.shared.u64 [%0], %1;" ::"r"(addr), "l"(x));
}
__device__ __forceinline__ unsigned long long get_slot(const unsigned long long* p) {
  unsigned long long x;
  asm volatile("ld.volatile.shared.u64 %0, [%1];" : "=l"(x) : "r"(smem_u32(p)));
  return x;
}
__device__ __forceinline__ void put_progress(int* p, int v) {
  asm volatile("st.volatile.shared.u32 [%0], %1;" ::"r"(smem_u32(p)), "r"(v) : "memory");
}
// spin until *p >= need (kUp) or <= need; a wait that has not completed
// after 2^26 tries (seconds) traps: a fault, not a hung card
template <bool kUp> __device__ __forceinline__ void wait_progress(const int* p, int need) {
  for (unsigned tries = 0;; ++tries) {
    int v;
    asm volatile("ld.volatile.shared.u32 %0, [%1];" : "=r"(v) : "r"(smem_u32(p)));
    if (kUp ? v >= need : v <= need) return;
    if (tries > (1u << 26)) __trap();
  }
}
// an empty slot: step -1, value 1e10
constexpr unsigned long long kEmptySlot = 0xffffffff501502f9ull;
// The P values of steps t0 + q * dt (q < P) from a ring into v, once every
// slot whose step lies in [t_lo, t_hi] carries it; the whole warp reads the
// same slots and agrees. A value of another step feeds only cells off the
// lattice: a warp's chunks start at its first row (P divides 32 K), so its
// first row's diagonal input at its first cell is its own initial 1e10.
template <int P>
__device__ __forceinline__ void read_ring(const unsigned long long* ring, int rmask, int t0, int dt,
                                          int t_lo, int t_hi, float* v) {
  for (unsigned tries = 0;; ++tries) {
    bool ok = true;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int t = t0 + q * dt;
      const unsigned long long x = get_slot(ring + (t & rmask));
      v[q] = __uint_as_float(static_cast<unsigned>(x));
      ok &= t < t_lo || t > t_hi || static_cast<int>(x >> 32) == t;
    }
    if (__all_sync(kFull, ok)) return;
    if (tries > (1u << 26)) __trap();
  }
}

// K consecutive floats (aligned to their size up to 16 bytes)
template <int K> __device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (K == 1) {
    p[0] = v[0];
  } else if constexpr (K == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < K; k += 4)
      *reinterpret_cast<float4*>(p + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  }
}
template <int K> __device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (K == 1) {
    v[0] = p[0];
  } else if constexpr (K == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x;
    v[1] = a.y;
  } else {
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + k);
      v[k] = a.x;
      v[k + 1] = a.y;
      v[k + 2] = a.z;
      v[k + 3] = a.w;
    }
  }
}

// K consecutive floats from device memory into shared memory (byte address
// dst), asynchronously
template <int K> __device__ __forceinline__ void cp_async_vec(unsigned dst, const float* src) {
  if constexpr (K <= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(dst), "l"(src), "n"(4 * K)
                 : "memory");
  } else {
#pragma unroll
    for (int k = 0; k < K; k += 4)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst + 4 * k), "l"(src + k)
                   : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// at most N of this thread's committed groups still in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// the steps (anti-diagonals) where warp w's rows hold cells, as chunks of P
struct WarpSpan {
  int row_lo, row_hi;  // rows [row_lo, row_hi)
  int c_lo, c_hi;      // chunks c_lo .. c_hi: steps c * P .. c * P + P - 1
};
__device__ __forceinline__ WarpSpan warp_span(int w, int K, int P, int N, int M) {
  WarpSpan sp;
  sp.row_lo = w * 32 * K;
  sp.row_hi = min(N, sp.row_lo + 32 * K);
  sp.c_lo = sp.row_lo / P;
  sp.c_hi = (sp.row_hi + M - 2) / P;
  return sp;
}

// Shared memory of a lattice's block of nwl warps, in bytes (each part a
// multiple of 16): the forward's hand-over rings and progress counts; the
// backward's weight stage, dD buffers, rings and counts.
__host__ __device__ constexpr int ring_bytes(int nwl, int P) {
  return nwl * kRingChunks * P * 8 + ((nwl + 3) / 4) * 16;
}
// the forward's weight buffer: each warp's chunk of P steps of 3 planes of
// its 32 K rows
__host__ __device__ constexpr int fwd_smem_bytes(int nwl, int K, int P) {
  return ring_bytes(nwl, P) + nwl * P * 3 * 32 * K * 4;
}
// two chunks of weights: the one the chain reads and the one in flight
__host__ __device__ constexpr int bwd_stage_floats(int nwl, int K, int P) {
  return 2 * P * 3 * 32 * nwl * K;
}
__host__ __device__ constexpr int bwd_ebuf_floats(int nwl, int K, int P) {
  return (nwl * P * (32 * K + 1) + 3) / 4 * 4;
}
__host__ __device__ constexpr int bwd_smem_bytes(int nwl, int K, int P) {
  return 4 * (bwd_stage_floats(nwl, K, P) + bwd_ebuf_floats(nwl, K, P)) + ring_bytes(nwl, P);
}
// floats of warp w's band of the residual: 32 K + M - 1 steps of 3 planes
// of its 32 K rows
__device__ __forceinline__ size_t band_floats(int K, int M) {
  return static_cast<size_t>(32 * K + M - 1) * 3 * 32 * K;
}

// ---------------------------------------------------------------- forward
// Shared memory: ring[nw][RING] (ring[w] holds R of the last row of warp
// w - 1 at step s in slot s % RING), taken[nw] (the last step of ring[w]
// that warp w has read), wbuf[nw][P][3][32 K] (each warp's weights of a
// chunk, its rows in order: the band's layout).
template <int K, int P>
__global__ void __launch_bounds__(kMaxThreads)
    soft_dtw_wave_fwd(const float* __restrict__ D, float* __restrict__ W, float* __restrict__ value,
                      int N, int M, float c, float gl) {
  extern __shared__ __align__(16) float smem[];
  constexpr int RING = kRingChunks * P, rmask = RING - 1;
  const int nw = blockDim.x >> 5, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned long long* rings = reinterpret_cast<unsigned long long*>(smem);
  int* taken = reinterpret_cast<int*>(rings + nw * RING);
  const int i0 = threadIdx.x * K;
  const WarpSpan sp = warp_span(w, K, P, N, M);
  for (int x = threadIdx.x; x < nw * RING; x += blockDim.x) rings[x] = kEmptySlot;
  if (lane == 0) taken[w] = sp.c_lo * P - 2;  // steps before its first need count as read
  __syncthreads();
  const int s_value = N + M - 2;
  const bool consumer = w > 0, producer = w < nw - 1;
  // the steps at which warp w - 1's last row holds cells
  const int t_lo = sp.row_lo - 1, t_hi = sp.row_lo + M - 2;
  const unsigned long long* ring_in = rings + w * RING;
  const unsigned ring_out = smem_u32(rings + (w + 1) * RING);
  // The weights go to a warp buffer a step, then out a chunk at a time: the
  // chunk is one contiguous run of the warp's band (wbuf has its layout),
  // stored as coalesced float4s, lane l the float4s l + 32 t. The band
  // starts at the warp's first step, row_lo = c_lo P (P divides 32 K).
  constexpr int F4_STEP = 3 * 8 * K;  // float4s of a step
  const int band_steps = 32 * K + M - 1;
  float* wbuf = reinterpret_cast<float*>(reinterpret_cast<char*>(smem) + ring_bytes(nw, P)) +
                w * P * 3 * 32 * K;
  float* Wb = W + (static_cast<size_t>(blockIdx.x) * nw + w) * band_floats(K, M);

  // Cells off the lattice are computed like the others and never read by
  // one on it: before a row starts (j < 0) every input is ~1e10 and so is R;
  // past its end (j >= M) R and the weights are not used. Rows past N read
  // row N - 1's distances. R(0, 0) = D(0, 0): its diagonal input starts at
  // 0, so its softmin is exactly 0.
  // D(i, s - i) of each row is loaded P steps ahead, at a column clamped
  // into the row: no load needs a predicate, and none is consumed in the
  // chunk that issues it.
  float r[K], upp[K], dq[K][P];
  const float* drow[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    r[k] = kInf;
    upp[k] = i0 + k == 0 ? 0.0f : kInf;
    drow[k] = D + static_cast<size_t>(blockIdx.x) * N * M + static_cast<size_t>(min(i0 + k, N - 1)) * M;
#pragma unroll
    for (int q = 0; q < P; ++q)
      dq[k][q] = __ldg(drow[k] + min(max(sp.c_lo * P + q - i0 - k, 0), M - 1));
  }

  for (int ch = sp.c_lo; ch <= sp.c_hi; ++ch) {
    const int s0 = ch * P;
    float ub[P];  // R of the last row of warp w - 1 at steps s0 - 1 .. s0 + P - 2
    if (consumer) {
      read_ring<P>(ring_in, rmask, s0 - 1, 1, t_lo, t_hi, ub);
    } else {
#pragma unroll
      for (int q = 0; q < P; ++q) ub[q] = kInf;
    }
    // before this chunk overwrites ring[w + 1], warp w + 1 has read what it held
    if (producer && lane == 31) wait_progress<true>(taken + w + 1, s0 + P - 1 - RING);
    const unsigned slot0 = ring_out + (s0 & rmask) * 8;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int s = s0 + q;
      float upin = __shfl_up_sync(kFull, r[K - 1], 1);
      if (lane == 0) upin = ub[q];
      float wv[3][K];
#pragma unroll
      for (int k = K - 1; k >= 0; --k) {
        const float up = k ? r[k - 1] : upin, left = r[k], dg = upp[k];
        upp[k] = up;
        const float mn = fminf(up, left), mx = fmaxf(up, left);
        const float m = fminf(mn, dg), hi = fmaxf(mx, dg), mid = fmaxf(mn, fminf(mx, dg));
        const float e1 = ex2((m - mid) * c), e2 = ex2((m - hi) * c);
        const float S = (e1 + e2) + 1.0f;
#ifdef LFS2_SOFT_DTW_NO_MEMORY
        const float dv = 1.0f;
#else
        const float dv = dq[k][q];
        dq[k][q] = __ldg(drow[k] + min(max(s + P - i0 - k, 0), M - 1));
#endif
        r[k] = dv + fmaf(lg2(S), -gl, m);
        const float rS = rcp(S), a1 = e1 * rS, a2 = e2 * rS;
        wv[0][k] = up == m ? rS : (up == mid ? a1 : a2);
        wv[1][k] = left == m ? rS : (left == mid ? a1 : a2);
        wv[2][k] = dg == m ? rS : (dg == mid ? a1 : a2);
      }
#ifdef LFS2_SOFT_DTW_NO_MEMORY
      if (M < 0) {  // never true: keeps the weights live without a store
#else
      {
#endif
#pragma unroll
        for (int x = 0; x < 3; ++x) store_vec<K>(wbuf + (q * 3 + x) * 32 * K + lane * K, wv[x]);
      }
      if (producer && lane == 31) put_slot(slot0 + 8 * q, r[K - 1], s);
      if (s == s_value) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (i0 + k == N - 1) value[blockIdx.x] = r[k];  // R(N - 1, M - 1)
      }
    }
    if (consumer && lane == 0) put_progress(taken + w, s0 + P - 2);
#ifndef LFS2_SOFT_DTW_NO_MEMORY
    __syncwarp();  // the chunk's weights are in wbuf
    const int t0 = s0 - sp.row_lo;  // the chunk's first step in the band
    float* wch = Wb + static_cast<size_t>(t0) * 3 * 32 * K;
#pragma unroll
    for (int t = 0; t < 3 * P * K / 4; ++t) {
      const int e = lane + 32 * t;
      if (t0 + e / F4_STEP < band_steps)  // steps past the band hold no cell
        *reinterpret_cast<float4*>(wch + 4 * e) = *reinterpret_cast<const float4*>(wbuf + 4 * e);
    }
    __syncwarp();  // wbuf is read before the next chunk writes it
#endif
  }
}

// --------------------------------------------------------------- backward
// Shared memory: stage[2 * P][3][T * K] (each thread's weights of two
// chunks' steps, its own K rows at t * K),
// ebuf[nw][P][32 K + 1] (each warp's dD of a chunk: step q's value of its
// local row 32 k + l, the row lane l owns as its k-th, at [q][32 k + l]),
// ring[nw][RING] (ring[w] holds what the first row of warp w + 1 sends up at
// step s, in slot s % RING), taken[nw] (the lowest step of ring[w] that warp
// w has read). Steps run downwards.
template <int K, int P>
__global__ void __launch_bounds__(kMaxThreads)
    soft_dtw_wave_bwd(const float* __restrict__ W, const float* __restrict__ g,
                      float* __restrict__ dD, int N, int M) {
  extern __shared__ __align__(16) float smem[];
  // a lane's successive dD values of a chunk at ebuf[.. + t TSTEP]
  constexpr int WS = 32 * K + 1, RPI = 32 / P, TSTEP = RPI / K;
  constexpr int RING = kRingChunks * P, rmask = RING - 1;
  static_assert(K * P <= 32, "a lane's writes of a chunk keep its row order");
  const int T = blockDim.x, nw = T >> 5, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int TK = T * K;
  float* stage = smem;
  float* ebuf = stage + bwd_stage_floats(nw, K, P) + w * P * WS;
  unsigned long long* rings = reinterpret_cast<unsigned long long*>(
      stage + bwd_stage_floats(nw, K, P) + bwd_ebuf_floats(nw, K, P));
  int* taken = reinterpret_cast<int*>(rings + nw * RING);
  const int i0 = threadIdx.x * K;
  const WarpSpan sp = warp_span(w, K, P, N, M);
  for (int x = threadIdx.x; x < nw * RING; x += T) rings[x] = kEmptySlot;
  if (lane == 0) taken[w] = sp.c_hi * P + P + 1;  // steps above its first need count as read
  __syncthreads();
  // this thread's rows in its warp's band, which starts at step row_lo
  const float* Wb = W + (static_cast<size_t>(blockIdx.x) * nw + w) * band_floats(K, M) + lane * K;
  const float gl = g[blockIdx.x];
  const bool consumer = w < nw - 1, producer = w > 0;
  // the steps at which warp w + 1's first row holds cells
  const int t_lo = sp.row_hi, t_hi = sp.row_hi + M - 1;
  const unsigned long long* ring_in = rings + w * RING;
  const unsigned ring_out = smem_u32(rings + (w - 1) * RING);
  const unsigned n_on = i0 < N ? static_cast<unsigned>(min(i0 + K, N) - 1 - i0 + M) : 0u;

  // copy this thread's weights of chunk ch into stage half ch % 2 (one
  // group a chunk, empty past the last); a step of the thread's cells lies
  // within the band (s - row_lo < (i0 - row_lo) + n_on <= 32 K + M - 1)
  const unsigned dst0 = smem_u32(stage + threadIdx.x * K);
  const auto issue = [&](int ch) {
#ifndef LFS2_SOFT_DTW_NO_MEMORY
    if (ch >= sp.c_lo) {
      const unsigned dst = dst0 + (ch & 1) * P * 3 * TK * 4;
      const float* src = Wb + static_cast<size_t>(ch * P - sp.row_lo) * 3 * 32 * K;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        if (static_cast<unsigned>(ch * P + q - i0) < n_on) {
#pragma unroll
          for (int x = 0; x < 3; ++x)
            cp_async_vec<K>(dst + (q * 3 + x) * TK * 4, src + (q * 3 + x) * 32 * K);
        }
      }
    }
#endif
    cp_async_commit();
  };

  // per row: E's carry along the row (cl), what goes to the row above
  // (snd), this row's diag term for the step after (pdp)
  float cl[K], snd[K], pdp[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    cl[k] = i0 + k == N - 1 ? 1.0f : 0.0f;  // E(N - 1, M - 1) = 1 arrives along its row
    snd[k] = 0.0f;
    pdp[k] = 0.0f;
  }
  // a chunk's dD leaves ebuf with coalesced stores: lane l writes step
  // q = l % P of local rows l / P + t RPI, P lanes a row
  float* dDl = dD + static_cast<size_t>(blockIdx.x) * N * M;
  const int cq = lane % P, crow = lane / P;
  const float* esrc = ebuf + cq * WS + (crow % K) * 32 + crow / K;
#ifdef LFS2_SOFT_DTW_NO_MEMORY
  float sink = 0.0f;
#endif
  issue(sp.c_hi);

  for (int ch = sp.c_hi; ch >= sp.c_lo; --ch) {
    issue(ch - 1);
    cp_async_wait<1>();  // chunk ch has landed; ch - 1 may be in flight
    const float* slot = stage + (ch & 1) * P * 3 * TK + threadIdx.x * K;
    const int s0 = ch * P;
    float ub[P];  // what the first row of warp w + 1 sent at steps s + 1
    if (consumer) {
      read_ring<P>(ring_in, rmask, s0 + P, -1, t_lo, t_hi, ub);
    } else {
#pragma unroll
      for (int q = 0; q < P; ++q) ub[q] = 0.0f;
    }
    // before this chunk overwrites ring[w - 1], warp w - 1 has read what it held
    if (producer && lane == 0) wait_progress<false>(taken + w - 1, s0 + RING);
    const unsigned slot0 = ring_out + (s0 & rmask) * 8;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int s = s0 + P - 1 - q;
      float wv[3][K];
#ifdef LFS2_SOFT_DTW_NO_MEMORY
#pragma unroll
      for (int k = 0; k < K; ++k) wv[0][k] = wv[1][k] = wv[2][k] = 0.33f;
#else
#pragma unroll
      for (int x = 0; x < 3; ++x) load_vec<K>(slot + ((P - 1 - q) * 3 + x) * TK, wv[x]);
#endif
      float bin = __shfl_down_sync(kFull, snd[0], 1);
      if (lane == 31) bin = ub[q];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool valid = i0 + k < N && static_cast<unsigned>(s - i0 - k) < static_cast<unsigned>(M);
        const float below = k < K - 1 ? snd[k + 1] : bin;
        const float e = valid ? cl[k] + below : 0.0f;
        cl[k] = valid ? e * wv[1][k] : cl[k];
        snd[k] = valid ? fmaf(e, wv[0][k], pdp[k]) : 0.0f;
        pdp[k] = valid ? e * wv[2][k] : 0.0f;
#ifdef LFS2_SOFT_DTW_NO_MEMORY
        sink += e;
#else
        ebuf[(P - 1 - q) * WS + 32 * k + lane] = e * gl;
#endif
      }
      if (producer && lane == 0) put_slot(slot0 + 8 * (P - 1 - q), snd[0], s);
    }
    if (consumer && lane == 31) put_progress(taken + w, s0 + 1);
#ifndef LFS2_SOFT_DTW_NO_MEMORY
    __syncwarp();  // the chunk's dD is in ebuf
    const int i_first = sp.row_lo + crow, s = s0 + cq;
#pragma unroll
    for (int t = 0; t < K * P; ++t) {
      const int i = i_first + t * RPI, j = s - i;
      if (i < N && static_cast<unsigned>(j) < static_cast<unsigned>(M))
        dDl[static_cast<size_t>(i) * M + j] = esrc[t * TSTEP];
    }
    __syncwarp();  // ebuf is read before the next chunk writes it
#endif
  }
#ifdef LFS2_SOFT_DTW_NO_MEMORY
  if (sink == 12345.0f) dDl[0] = sink;  // keeps the chain live
#endif
  cp_async_wait<0>();
}

// ---------------------------------------------------------------- launches
// the latest accepted launch of each kernel: rows a thread, threads, steps a
// chunk, shared-memory bytes, blocks
int g_last_launch[2][5];

// opt a kernel in to all the shared memory a block may have, once (a launch
// then sets no attribute, so launches can be captured in a CUDA graph)
template <typename Kern> cudaError_t opt_in_smem(Kern kernel, int smem) {
  static Kern done[32];
  static int n_done = 0;
  if (smem <= 48 * 1024) return cudaSuccess;
  for (int n = 0; n < n_done; ++n)
    if (done[n] == kernel) return cudaSuccess;
  const cudaError_t err = lfs2::allow_smem(kernel, kMaxSmem);
  if (err == cudaSuccess && n_done < 32) done[n_done++] = kernel;
  return err;
}

// what every launch must satisfy: nwl warps of K rows a thread cover the N
// rows with no warp empty, within the thread limit
bool launch_ok(int N, int M, int K, int nwl) {
  const int T = 32 * nwl;
  return N >= 1 && M >= 1 && nwl >= 1 && T <= kMaxThreads && T * K >= N && (T - 32) * K < N &&
         static_cast<long long>(N) * M < (1ll << 31);
}

template <typename Kern, typename... Args>
int launch(int which, Kern kern, int L, int K, int nwl, int P, int smem, cudaStream_t stream,
           Args... args) {
  cudaError_t err = opt_in_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<L, 32 * nwl, smem, stream>>>(args...);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    const int rec[5] = {K, 32 * nwl, P, smem, L};
    for (int i = 0; i < 5; ++i) g_last_launch[which][i] = rec[i];
  }
  return static_cast<int>(err);
}

}  // namespace

LFS2_DEFINE_ERROR_STRING

// D (L, N, M) f32 -> W (L, nwl, 32 K + M - 1, 3, 32 K) each warp's band of
// weights, value (L,). c = log2(e) / gamma, gl = gamma * ln(2); K rows a
// thread, nwl warps a lattice (one block), P steps a chunk.
LFS2_EXPORT int lfs2_soft_dtw_fwd(const float* D, float* W, float* value, int L, int N, int M,
                                  float c, float gl, int K, int nwl, int P, int smem,
                                  void* stream) {
  if (!launch_ok(N, M, K, nwl) || smem != fwd_smem_bytes(nwl, K, P) || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  void (*kern)(const float*, float*, float*, int, int, float, float) = nullptr;
  if (K == 1 && P == 16) kern = soft_dtw_wave_fwd<1, 16>;
  if (K == 2 && P == 8) kern = soft_dtw_wave_fwd<2, 8>;
  if (K == 4 && P == 8) kern = soft_dtw_wave_fwd<4, 8>;
  if (K == 8 && P == 1) kern = soft_dtw_wave_fwd<8, 1>;
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(0, kern, L, K, nwl, P, smem, static_cast<cudaStream_t>(stream), D, W, value, N,
                M, c, gl);
}

// W from the forward, g (L,) the upstream gradient -> dD (L, N, M) = g * dValue/dD.
// K rows a thread, nwl warps a lattice (one block), P steps a chunk.
LFS2_EXPORT int lfs2_soft_dtw_bwd(const float* W, const float* g, float* dD, int L, int N, int M,
                                  int K, int nwl, int P, int smem, void* stream) {
  if (!launch_ok(N, M, K, nwl) || smem != bwd_smem_bytes(nwl, K, P) || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  void (*kern)(const float*, const float*, float*, int, int) = nullptr;
  if (K == 1 && P == 8) kern = soft_dtw_wave_bwd<1, 8>;
  if (K == 2 && P == 4) kern = soft_dtw_wave_bwd<2, 4>;
  if (K == 4 && P == 2) kern = soft_dtw_wave_bwd<4, 2>;
  if (K == 8 && P == 2) kern = soft_dtw_wave_bwd<8, 2>;
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(1, kern, L, K, nwl, P, smem, static_cast<cudaStream_t>(stream), W, g, dD, N, M);
}

// the latest accepted launches: out[0..4] the forward's, out[5..9] the backward's
LFS2_EXPORT int lfs2_soft_dtw_last_launch(int* out) {
  for (int i = 0; i < 5; ++i) {
    out[i] = g_last_launch[0][i];
    out[5 + i] = g_last_launch[1][i];
  }
  return 0;
}

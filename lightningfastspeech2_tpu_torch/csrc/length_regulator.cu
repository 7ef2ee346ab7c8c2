// length_regulator: expand phone rows to frames by duration (forward) and
// sum frame gradients back onto their phones (backward), one launch each.
//
// Replaces lightningfastspeech2_tpu/ops/pallas_length_regulator.py
// regulate_pallas: _expand_kernel (:30) and _grad_kernel (:66), and the
// clamp, cast and cumsum around them (:148). On the TPU both kernels are
// one-hot matmuls on the MXU, (T_tile x P) x (P x H) per 256-frame tile, run
// at HIGHEST precision in f32 so that the selection stays exact. Here the
// forward is a plain row copy, exact in any dtype, and the one-hot trick is
// not ported. Both kernels are bound by bytes.
//
// regulate_fwd_kernel: frame t of item b copies phone #{ends <= t}, zero for
// t >= total, where ends are the running sums of the durations clamped at 0
// and cast to int32 (the JAX order: maximum, astype(int32), cumsum). The
// kernel takes the durations as the model gives them (int32 or int64, any
// strides) and writes frames (B, T, H), the mask (B, T) (t < min(total, T))
// and ends (B, P) int32 for the backward, so a regulator call is this one
// launch. A block owns a run of F frames of one item (F from the wrapper's
// plan) and scans the item's durations in chunks of kThreads phones, loaded
// kScanAhead chunks at a time: each thread clamps one duration of a chunk,
// a block-wide prefix sum gives the chunk's ends, and each phone marks the
// tile's frames it owns in a shared frame -> phone table (no search per
// frame; a phone's frames are one run). The scan stops once the tile is
// covered, except in the item's first block, which writes the item's ends.
// Rows are then copied whole, in 16-byte vectors where the row and both
// tensors' row starts allow it (4 and 2 bytes where they do not), several
// loads in flight a thread; the tile's frames are contiguous in the output,
// so consecutive threads store consecutive vectors. Bound: bytes
// (durations, x, frames, mask, ends).
//
// regulate_bwd_kernel: dx[b, p] = sum of g[b, t] over the frames phone p
// owns in [0, min(total, T)), from the forward's ends. S warps per (item,
// phone, 32 lane-vectors of the row), 8 / S such units a block of 8 warps,
// S (1, 2, 4 or 8, a template argument) from the wrapper's plan: 1 where
// the grid gives every SM a block, more on smaller grids, which would
// otherwise leave each SM a few warps with a phone's whole run of loads in
// a chain. At H = 256 in bf16 a lane loads 16 bytes a frame and one warp
// covers the row; warp s of a unit sums frames s, s + S, ... in frame order
// in f32, kSumFrames frames' loads in flight; the S partial rows meet in
// shared memory, where the unit's threads share out the columns, add each
// column's partial sums in warp order and round once to g's dtype. No
// atomics: the order depends on the shape alone, so the result repeats bit
// for bit. g is taken with its strides (autograd may hand over an expanded
// or transposed gradient): 16-byte loads where the rows are contiguous and
// aligned, one element a load otherwise; S does not depend on which, so
// both sum in the same order. Bound: bytes (g's frames below each item's
// total, ends, dx).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanAhead = 4;    // forward: chunks of durations loaded together
constexpr int kCopyUnroll = 8;   // forward: vector loads in flight a thread
constexpr int kSumFrames = 4;    // backward: frames' loads in flight a lane
constexpr int kBwdBlocksPerSM = 6;  // backward: six blocks an SM, 40 registers a thread

// ---------------------------------------------------------------- forward
// grid (ceil(T / F), B), kThreads threads, F ints of dynamic shared memory.
// V is the copy unit; x's strides are in V units (xsh 1 unless V is one
// element), the durations' in elements.
template <typename V, typename D>
__global__ void __launch_bounds__(kThreads)
regulate_fwd_kernel(const V* __restrict__ x, long long xsb, long long xsp, long long xsh,
                    const D* __restrict__ dur, long long dsb, long long dsp,
                    V* __restrict__ out, unsigned char* __restrict__ mask, int* __restrict__ ends,
                    int P, int T, int F, int row_vecs) {
  extern __shared__ int s_phone[];   // the tile's frame -> phone, -1 past the total
  __shared__ unsigned s_warp[kWarps];
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int t0 = blockIdx.x * F;
  const int nf = min(F, T - t0);
  for (int f = tid; f < nf; f += kThreads) s_phone[f] = -1;
  const bool first = blockIdx.x == 0;  // writes the item's ends
  const D* db = dur + b * dsb;
  unsigned carry = 0;                  // running sum before the chunk (int32 wraps)
  bool covered = false;
  // kScanAhead chunks' durations are loaded together, one round trip for
  // up to kScanAhead * kThreads phones
  for (int r0 = 0; r0 < P && !covered; r0 += kScanAhead * kThreads) {
    unsigned vs[kScanAhead];
#pragma unroll
    for (int a = 0; a < kScanAhead; ++a) {
      const int p = r0 + a * kThreads + tid;
      const D dv = p < P ? db[p * dsp] : D(0);
      vs[a] = static_cast<unsigned>(dv > D(0) ? dv : D(0));
    }
#pragma unroll
    for (int a = 0; a < kScanAhead; ++a) {
      const int c0 = r0 + a * kThreads;
      if (c0 >= P) break;
      const int p = c0 + tid;
      const unsigned v = vs[a];
      // inclusive prefix sum over the block: within the warp, then the warps
      unsigned s = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned u = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += u;
      }
      __syncthreads();                 // the previous chunk's s_warp and table writes are done
      if (lane == 31) s_warp[warp] = s;
      __syncthreads();
      unsigned before = carry, chunk = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const unsigned ws = s_warp[w];
        if (w < warp) before += ws;
        chunk += ws;
      }
      const int stop = static_cast<int>(before + s);   // ends[p]
      const int start = stop - static_cast<int>(v);     // ends[p - 1]
      if (p < P) {
        if (first) ends[static_cast<size_t>(b) * P + p] = stop;
        const int lo = max(start, t0), hi = min(stop, t0 + nf);
        for (int t = lo; t < hi; ++t) s_phone[t - t0] = p;
      }
      carry += chunk;
      if (!first && static_cast<int>(carry) >= t0 + nf) {  // the tile is covered
        covered = true;
        break;
      }
    }
  }
  __syncthreads();
  for (int f = tid; f < nf; f += kThreads)
    mask[static_cast<size_t>(b) * T + t0 + f] = s_phone[f] >= 0;
  const V* xb = x + b * xsb;
  V* ob = out + (static_cast<size_t>(b) * T + t0) * row_vecs;
  const int n = nf * row_vecs;
  // vector i of the tile is column c of frame f; both advance by
  // divmod(kThreads, row_vecs) from one item of a thread to its next
  const int df = kThreads / row_vecs, dc = kThreads - df * row_vecs;
  int f = tid / row_vecs, c = tid - (tid / row_vecs) * row_vecs;
  for (int i0 = tid; i0 < n; i0 += kThreads * kCopyUnroll) {
    V v[kCopyUnroll];
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) {
      v[u] = V{};
      if (i0 + u * kThreads < n) {
        const int ph = s_phone[f];
        if (ph >= 0) v[u] = xb[ph * xsp + c * xsh];
      }
      f += df;
      c += dc;
      if (c >= row_vecs) {
        c -= row_vecs;
        ++f;
      }
    }
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) ob[i] = v[u];
    }
  }
}

// --------------------------------------------------------------- backward
// N elements a lane load: 16 bytes (g's rows contiguous and aligned) or 1
// (any strides); g's strides are in elements. Vec is the load's type.
template <typename T, int N> struct Vec;
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<__nv_bfloat16, 8> { using type = uint4; };

template <> struct Vec<float, 1> { using type = float; };
template <> struct Vec<__nv_bfloat16, 1> { using type = __nv_bfloat16; };

// add one loaded row piece (N elements) to the f32 sums
template <typename T, int N>
__device__ __forceinline__ void add_row(const typename Vec<T, N>::type& r, float* acc) {
  if constexpr (N == 1) {
    acc[0] += lfs2::to_f(r);
  } else {
    float d[N];
    lfs2::load_vec<N>(reinterpret_cast<const T*>(&r), d);
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] += d[k];
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_row(T* p, const float* a) {
  if constexpr (N == 1) {
    p[0] = lfs2::from_f<T>(a[0]);
  } else {
    typename Vec<T, N>::type v;
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int k = 0; k < N; ++k) e[k] = lfs2::from_f<T>(a[k]);
    *reinterpret_cast<typename Vec<T, N>::type*>(p) = v;
  }
}

// grid (ceil(P * groups / (kWarps / S)), B), kThreads threads: S warps per
// (phone, column group of 32 * N elements) of item blockIdx.y
template <typename T, int N, int S>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSM)
regulate_bwd_kernel(const T* __restrict__ g, long long gsb, long long gst, long long gsh,
                    const int* __restrict__ ends, T* __restrict__ dx, int P, int Tf, int H,
                    int groups, int group_shift) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, s = warp % S;
  const int b = blockIdx.y;
  const int unit = blockIdx.x * (kWarps / S) + warp / S;
  // the unit's phone and column group: a shift where groups is a power of
  // two (1 at H = 256 in bf16, 2 in f32), a division on the critical path
  // to the first load otherwise
  const int p = group_shift >= 0 ? unit >> group_shift : unit / groups;
  const int grp = unit - p * groups;
  const int h0 = (grp * 32 + lane) * N;
  // no early return: a unit's warps meet at the barrier below
  const bool active = p < P && h0 < H;
  float acc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = 0.0f;
  if (active) {
    const int* e = ends + static_cast<size_t>(b) * P;
    const int start = min(p == 0 ? 0 : e[p - 1], Tf);
    const int stop = min(e[p], Tf);  // ends[p] <= total: frames past it are not summed
    const T* gp = g + b * gsb + h0 * gsh;
    // groups of kSumFrames of the warp's frames, their loads issued
    // together and kept raw until all are in flight; then the rest, one
    // frame at a time for one warp a phone (groups of 8, predicated groups,
    // groups that load the last frame again in place of the rest, and
    // 2-byte loads on small grids measured no faster), predicated loads
    // issued together for a split run, whose warps each hold a few frames
    using R = typename Vec<T, N>::type;
    int t = start + s;
    for (; t + (kSumFrames - 1) * S < stop; t += kSumFrames * S) {
      R r[kSumFrames];
#pragma unroll
      for (int u = 0; u < kSumFrames; ++u)
        r[u] = *reinterpret_cast<const R*>(gp + (t + u * S) * gst);
#pragma unroll
      for (int u = 0; u < kSumFrames; ++u) add_row<T, N>(r[u], acc);
    }
    if constexpr (S == 1) {
      for (; t < stop; ++t) add_row<T, N>(*reinterpret_cast<const R*>(gp + t * gst), acc);
    } else {
      R r[kSumFrames - 1];
#pragma unroll
      for (int u = 0; u < kSumFrames - 1; ++u)
        if (t + u * S < stop) r[u] = *reinterpret_cast<const R*>(gp + (t + u * S) * gst);
#pragma unroll
      for (int u = 0; u < kSumFrames - 1; ++u)
        if (t + u * S < stop) add_row<T, N>(r[u], acc);
    }
  }
  if constexpr (S > 1) {
    // the S partial rows meet in shared memory in the row's own order,
    // [warp][lane][k]; then the unit's 32 * S threads share out the row's
    // columns, each adding a column's S partial sums in warp order, and
    // consecutive threads store consecutive columns
    __shared__ __align__(16) float s_part[kWarps * 32 * N];
    float* mine = s_part + (warp * 32 + lane) * N;
    if constexpr (N % 4 == 0) {
#pragma unroll
      for (int k = 0; k < N; k += 4)
        *reinterpret_cast<float4*>(mine + k) =
            make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) mine[k] = acc[k];
    }
    __syncthreads();
    if (p >= P) return;
    const float* part = s_part + (warp - s) * 32 * N;   // the unit's first warp's
    const int c0 = grp * 32 * N, cols = min(32 * N, H - c0);
    T* out = dx + (static_cast<size_t>(b) * P + p) * H + c0;
    for (int c = s * 32 + lane; c < cols; c += 32 * S) {
      float a = part[c];
#pragma unroll
      for (int j = 1; j < S; ++j) a += part[j * 32 * N + c];
      out[c] = lfs2::from_f<T>(a);
    }
    return;
  }
  if (active) store_row<T, N>(dx + (static_cast<size_t>(b) * P + p) * H + h0, acc);
}

template <typename V, typename D>
cudaError_t launch_fwd(const void* x, long long sb, long long sp, long long sh, const void* dur,
                       long long dsb, long long dsp, void* out, void* mask, int* ends, int B,
                       int P, int T, int F, int row_bytes, cudaStream_t stream) {
  const long long n = sizeof(V);
  const dim3 grid((T + F - 1) / F, B);
  regulate_fwd_kernel<V, D><<<grid, kThreads, F * static_cast<int>(sizeof(int)), stream>>>(
      static_cast<const V*>(x), sb / n, sp / n, sh / n, static_cast<const D*>(dur), dsb, dsp,
      static_cast<V*>(out), static_cast<unsigned char*>(mask), ends, P, T, F,
      row_bytes / static_cast<int>(n));
  return cudaGetLastError();
}

template <typename V>
cudaError_t launch_fwd_d(const void* x, long long sb, long long sp, long long sh, const void* dur,
                         long long dsb, long long dsp, int dur_bytes, void* out, void* mask,
                         int* ends, int B, int P, int T, int F, int row_bytes, cudaStream_t s) {
  if (dur_bytes == 8)
    return launch_fwd<V, long long>(x, sb, sp, sh, dur, dsb, dsp, out, mask, ends, B, P, T, F,
                                    row_bytes, s);
  if (dur_bytes == 4)
    return launch_fwd<V, int>(x, sb, sp, sh, dur, dsb, dsp, out, mask, ends, B, P, T, F,
                              row_bytes, s);
  return cudaErrorInvalidValue;
}

template <typename T, int N, int S>
cudaError_t launch_bwd_split(const void* g, long long sb, long long st, long long sh,
                             const int* ends, void* dx, int B, int P, int Tf, int H,
                             cudaStream_t stream) {
  const int groups = (H + 32 * N - 1) / (32 * N);
  const long long units = static_cast<long long>(P) * groups;
  if (units > 0x7fffffffLL - kWarps) return cudaErrorInvalidConfiguration;
  int shift = 0;
  while ((1 << shift) < groups) ++shift;
  const dim3 grid(static_cast<unsigned>((units + kWarps / S - 1) / (kWarps / S)), B);
  regulate_bwd_kernel<T, N, S><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(g), sb, st, sh, ends, static_cast<T*>(dx), P, Tf, H, groups,
      (1 << shift) == groups ? shift : -1);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch_bwd(const void* g, long long sb, long long st, long long sh, const int* ends,
                       void* dx, int B, int P, int Tf, int H, int S, cudaStream_t stream) {
  switch (S) {
    case 1: return launch_bwd_split<T, N, 1>(g, sb, st, sh, ends, dx, B, P, Tf, H, stream);
    case 2: return launch_bwd_split<T, N, 2>(g, sb, st, sh, ends, dx, B, P, Tf, H, stream);
    case 4: return launch_bwd_split<T, N, 4>(g, sb, st, sh, ends, dx, B, P, Tf, H, stream);
    case 8: return launch_bwd_split<T, N, 8>(g, sb, st, sh, ends, dx, B, P, Tf, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

LFS2_DEFINE_ERROR_STRING

// x (B, P, H) with element strides (xs0, xs1, xs2) -> frames (B, T, H), mask
// (B, T) bool, ends (B, P) int32; durations (B, P) of dur_bytes 4 or 8
// (int32, int64) with element strides (ds0, ds1); F frames a block. The
// copy is dtype-blind: elem_bytes is x's element size.
LFS2_EXPORT int lfs2_regulate_fwd(const void* x, long long xs0, long long xs1, long long xs2,
                                  const void* dur, long long ds0, long long ds1, int dur_bytes,
                                  void* out, void* mask, int* ends, int B, int P, int T, int H,
                                  int elem_bytes, int F, void* stream) {
  const long long xs[3] = {xs0, xs1, xs2}, ds[2] = {ds0, ds1};
  if (B < 1 || P < 1 || T < 1 || H < 1 || F < 1 || B > 65535) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long es = elem_bytes, row_bytes = static_cast<long long>(H) * es;
  const long long sb = xs[0] * es, sp = xs[1] * es, sh = xs[2] * es;
  // the widest copy unit every row start of x and of the frames is aligned
  // to; a unit wider than an element needs x's rows contiguous
  const auto fits = [&](long long n) {
    return row_bytes % n == 0 && reinterpret_cast<uintptr_t>(x) % n == 0 &&
           reinterpret_cast<uintptr_t>(out) % n == 0 && sb % n == 0 && sp % n == 0 &&
           (sh == es || n == es);
  };
  const int rb = static_cast<int>(row_bytes);
  if (fits(16))
    return launch_fwd_d<uint4>(x, sb, sp, 16, dur, ds[0], ds[1], dur_bytes, out,
                               mask, ends, B, P, T, F, rb, s);
  if (fits(4))
    return launch_fwd_d<unsigned>(x, sb, sp, sh == es ? 4 : sh, dur, ds[0], ds[1], dur_bytes,
                                  out, mask, ends, B, P, T, F, rb, s);
  if (fits(2))
    return launch_fwd_d<unsigned short>(x, sb, sp, sh == es ? 2 : sh, dur, ds[0], ds[1],
                                        dur_bytes, out, mask, ends, B, P, T, F, rb, s);
  return cudaErrorInvalidValue;
}

// g (B, T, H) with element strides (gs0, gs1, gs2) -> dx (B, P, H)
// contiguous in the same dtype (lfs2::DType code), from ends (B, P) int32;
// S warps a phone run (1, 2, 4 or 8)
LFS2_EXPORT int lfs2_regulate_bwd(const void* g, long long gs0, long long gs1, long long gs2,
                                  const int* ends, void* dx, int B, int P, int T, int H,
                                  int dtype, int S, void* stream) {
  const long long gs[3] = {gs0, gs1, gs2};
  if (B < 1 || P < 1 || H < 1 || B > 65535) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int es = dtype == lfs2::kF32 ? 4 : 2;
  // 16 bytes a load where g's rows are contiguous and every row start is aligned
  const bool wide = gs[2] == 1 && (static_cast<long long>(H) * es) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(g) % 16 == 0 && (gs[0] * es) % 16 == 0 &&
                    (gs[1] * es) % 16 == 0;
  if (dtype == lfs2::kF32)
    return static_cast<int>(
        wide ? launch_bwd<float, 4>(g, gs[0], gs[1], 1, ends, dx, B, P, T, H, S, s)
             : launch_bwd<float, 1>(g, gs[0], gs[1], gs[2], ends, dx, B, P, T, H, S, s));
  if (dtype == lfs2::kBF16)
    return static_cast<int>(
        wide ? launch_bwd<__nv_bfloat16, 8>(g, gs[0], gs[1], 1, ends, dx, B, P, T, H, S, s)
             : launch_bwd<__nv_bfloat16, 1>(g, gs[0], gs[1], gs[2], ends, dx, B, P, T, H, S, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

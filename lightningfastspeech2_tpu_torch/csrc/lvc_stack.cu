// lvc_stack: FastDiff's time-aware LVC chain, every layer of one upsample
// stage in one launch.
//
// Per layer i (d = 3^i), on x (B, L, C) with audio_down ad:
//   x = round(x + ad); y1 = round(leaky(x, 0.2))          zero outside [0, L)
//   y2 = round(leaky(conv3_d(y1) + conv_b[i], 0.2))       f32 sum, zero outside
//   g[t] = sum_k y2[t - 1 + k] @ K_f[i][:, :, k] + bias_f[i]   (f = t / hop)
//   x = round(x + round(sigmoid(g[:C]) * tanh(g[C:])))    (or the Padé gate)
// round() is the working dtype (f32 or bf16); products sum in f32; biases
// and conv biases are f32. The per-frame kernels K are read in the kernel
// predictor's layout, (B, nL, layers, C_in, 2C, 3), straight from device
// memory; conv_w is (layers, 3, C_in, C_out). C is a template parameter,
// built at 16, 32, 64 and 128 (ops/fastdiff_lvc.py pads other widths up to
// 128 with zero channels, which stay zero through every layer); past 128 the
// wide route at the end of this file takes any C, a layer at a time.
//
// Replaces lightningfastspeech2_tpu/ops/pallas_fastdiff.py _stack_kernel
// (fused_lvc_stack). The TPU kernel's prev/cur/next halo blocks, its halo of
// whole frames, the VMEM-sized frame tiles and the transposed, padded copy of
// the LVC kernels were Mosaic workarounds and are not carried over: a block
// here owns `tile` output rows and a halo in rows, and every row finds its
// frame's kernel by t / hop.
//
// What bounds it on an H100. bf16: bytes. At a 512-frame bucket and C = 32,
// stage 3 (hop 256, L = 131,072) reads x, ad and 25 MB of per-frame kernels
// and writes x: about 51 MB (15 us at 3.35 TB/s) against 9.7 GFLOP (9.8 us
// at the bf16 tensor-core peak); stage 2 (hop 64) about 31 MB, most of it the
// per-frame kernels, whose 25 MB do not depend on the hop and each serve
// only 64 rows. f32: operations. About 100 MB (30 us) against the same
// products as split TF32, three TF32 products each (59 us at 165 TFLOP/s
// of f32-accurate products; mma.sync itself reaches about 320 TFLOP/s of
// TF32 on an H100 at 700 W, so its floor is about 90 us). Both grow with C
// squared (the kernels and the products) past the signal's C. What the
// design does about it: x, ad
// and the LVC's input stay in shared memory for all layers, so each input
// byte is read once and the output written once; the conv's input is
// formed from x in registers; only the halo rows (48 a side at 4 layers)
// are read again by the neighbouring block; each frame's kernel comes once
// per block and layer from device memory (L2 for a neighbouring block's
// halo frame), fetched a round ahead so that it lands while the block
// computes; and the products run on the tensor cores.
//
// Tensor-core route (lvc_mma_kernel, hop a multiple of 8). Both products
// are formed transposed, out^T = W^T @ rows^T: M = the output channels (C
// for the conv, 2C for the LVC), K = 3C in the JAX wrapper's order k = tap *
// C + cin (pallas_fastdiff.py:193), N = 8 signal rows. The outputs are taken
// in groups of CG = min(C, 32) channels: a conv group is CG / 16 m16 tiles,
// an LVC group the CG / 16 tiles of sigmoid rows c.. beside the CG / 16 of
// tanh rows C + c.., so that a thread holds both halves of a gate. The
// weights are A; the signal is B, read through ldmatrix from the
// shared-memory rows with one row address per lane, so a tap's shift (-d,
// 0, +d for the conv, -1, 0, +1 for the LVC) is an address and never a
// copy. Why transposed: an n8 tile of 8 rows lies in one frame whenever hop
// % 8 == 0, so the one form serves stage 1 (hop 8, where an m16 tile of
// rows would span two frames with different kernels) as well as stages 2
// and 3; and a warp's A fragments serve all nt row tiles of its chunk, which
// at nt = 4 reads as few weight bytes per product as 32-row A tiles would.
// The leaky on the conv's input is applied to the B fragments.
//   Staged (bf16 at C <= 64, f32 at C <= 32; route "mma"): the weights are
// staged in shared memory and read through ldmatrix.
//   bf16: mma.sync m16n8k16; 16 warps. Weights staged [k][out] and read
// with ldmatrix.trans. A round's raw (cin, out, tap) kernels land by bulk
// copies (cp.async.bulk, one a frame, issued by one thread and counted on
// an mbarrier, so no warp stalls issuing them) and are reordered once into
// [tap * C + cin][out]; the next round's copies (or the next layer's
// first, with its conv taps) are issued once the conv is done, so they
// overlap this round's LVC.
//   f32: split-TF32 m16n8k8 (csrc/mma.cuh), three products a_hi b_lo +
// a_lo b_hi + a_hi b_hi in three passes over the accumulators, as
// csrc/flash_attention.cu forms f32 products on the tensor cores; 8 warps
// (the split operands need more than 128 registers a thread). The weights
// are split once a block and layer into hi and lo halves stored [out][k],
// so ldmatrix gives A fragments that need no conversion; the signal is
// split in registers as it is loaded. Split kernels leave no room for raw
// copies, so the next round's raw kernels wait in registers. At one n8
// tile a frame (hop 8) neither a split nor a reordered copy would be
// reused: the LVC reads each frame's raw kernel as it landed, from two
// bulk-copy slots by round parity (raw_products).
//   Direct (bf16 at C = 128, f32 at C >= 64; route "mma_direct"): one
// frame's kernel of one layer is 6 C^2 values (196 KB in bf16 at C = 128,
// and as much in f32 at C = 64 once split), so no staged copy fits beside
// the rows. Shared memory holds only the signal rows; each warp reads its
// A fragments straight from device memory by scalar loads (L2, where a
// frame's kernel is reused by every chunk of its rows), split in registers
// in f32. Right, and slower than its bound by more than the staged route
// (PERF.md).
//   Per layer: the conv's rows, then the LVC's rows (staged: round by
// round, a round holding the kernels of up to round_frames frames); each
// step's n8 tiles are split evenly over the warps, each warp taking every
// channel group of its tiles. Epilogues in registers: the conv
// adds its bias, the leaky, the round and the zero outside [0, L); the LVC
// its frame's bias, the gate (__expf and __fdividef: no IEEE-division slow
// path), the round and the residual add, and (but in the last layer) the
// next layer's x + ad.
//
// CUDA-core route (lvc_stack_kernel): hops that are not a multiple of 8,
// and chains whose tensor-core launch does not fit shared memory (f32 with
// more than 4 layers), by the rule on shape in ops/fastdiff_lvc.py
// lvc_plan. Plain f32 FMAs, lane = channel (C / 32 channels a lane past 32,
// half the warp at C = 16).
#include "common.cuh"
#include "gemm_mma.cuh"
#include "mma.cuh"

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 6;
constexpr int kAlign = 4;     // region rounding; rows per chunk when hop % 4 == 0
constexpr int kConvRows = 4;  // rows per chunk of the dilated conv
constexpr int kMaxSmem = 232448;
constexpr int kRouteCores = 0, kRouteMma = 1, kRouteDirect = 2;

// the latest accepted launch: route, tile, grid x, grid y, shared-memory
// bytes a block, frames staged a round, n8 row tiles of an LVC chunk,
// channels
int g_last_launch[8];

cudaError_t record_launch(int route, int tile, const dim3& grid, int smem, int round_frames,
                          int nt, int channels) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    const int rec[8] = {route, tile, static_cast<int>(grid.x), static_cast<int>(grid.y), smem,
                        round_frames, nt, channels};
    for (int i = 0; i < 8; ++i) g_last_launch[i] = rec[i];
  }
  return err;
}

// Buffer rows (row 0 is signal position blockIdx.x * tile - halo) of each
// step of each layer: the residual add and leaky [a_lo, a_hi), the dilated
// conv [b_lo, b_hi), the LVC and gate [c_lo, c_hi). Each step covers what
// the next one reads; c of the last layer covers the tile.
struct Spec {
  int layers, halo, rows;
  int a_lo[kMaxLayers], a_hi[kMaxLayers];
  int b_lo[kMaxLayers], b_hi[kMaxLayers];
  int c_lo[kMaxLayers], c_hi[kMaxLayers];
};

// The arguments of one launch, as the library takes them
struct Args {
  const void* x;
  const void* ad;
  const void* kern;
  const float* bias;
  const void* conv_w;
  const float* conv_b;
  void* out;
  int B, L, hop, layers, tile, fast, route, round_frames, nt;
};

// The gate, both routes: sigmoid(a) * tanh(b) with tanh(b) = 2 sigmoid(2b)
// - 1 and sigmoid(z) = 1 / (1 + e^-z) from __expf and __fdividef (within
// 2e-7 of the exact gate; no IEEE-division slow path), or the Padé gate
// (clamped Padé(7,6) tanh, as vocoder/fastdiff.py fast_tanh) with its one
// division a __fdividef
__device__ __forceinline__ float sigmoid_fast(float z) {
  return __fdividef(1.0f, 1.0f + __expf(-z));
}

__device__ __forceinline__ float pade_tanh(float t) {
  t = fminf(fmaxf(t, -4.97f), 4.97f);
  const float t2 = t * t;
  const float num = t * (135135.0f + t2 * (17325.0f + t2 * (378.0f + t2)));
  const float den = 135135.0f + t2 * (62370.0f + t2 * (3150.0f + t2 * 28.0f));
  return fminf(fmaxf(__fdividef(num, den), -1.0f), 1.0f);
}

template <bool FAST>
__device__ __forceinline__ float gate(float a, float b) {
  if (FAST) return (0.5f * (pade_tanh(0.5f * a) + 1.0f)) * pade_tanh(b);
  return sigmoid_fast(a) * (2.0f * sigmoid_fast(2.0f * b) - 1.0f);
}

// ============================ CUDA-core route ===============================
template <typename T, int C, int RPT, bool FAST>
__global__ void __launch_bounds__(kThreads)
lvc_stack_kernel(const T* __restrict__ x, const T* __restrict__ ad, const T* __restrict__ kern,
                 const float* __restrict__ bias, const T* __restrict__ conv_w,
                 const float* __restrict__ conv_b, T* __restrict__ out, int L, int hop,
                 int tile, Spec spec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int R = spec.rows;
  T* xs = reinterpret_cast<T*>(smem_raw);  // x, rounded to T
  T* as = xs + R * C;                      // audio_down
  T* y1 = as + R * C;                      // leaky(x): the conv's input
  T* y2 = y1 + R * C;                      // the LVC's input (last: see the conv below)
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int g0 = t0 - spec.halo;
  const int nL = L / hop;
  const long long base = static_cast<long long>(b) * L * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T zero = lfs2::from_f<T>(0.0f);

  for (int idx = spec.a_lo[0] * C + threadIdx.x; idx < spec.a_hi[0] * C; idx += kThreads) {
    const int g = g0 + idx / C;
    const bool in = g >= 0 && g < L;
    const long long o = base + static_cast<long long>(g) * C + (idx % C);
    xs[idx] = in ? x[o] : zero;
    as[idx] = in ? ad[o] : zero;
  }
  __syncthreads();

  int d = 1;
  for (int i = 0; i < spec.layers; ++i, d *= 3) {
    // residual add, then the conv's input
    for (int idx = spec.a_lo[i] * C + threadIdx.x; idx < spec.a_hi[i] * C; idx += kThreads) {
      const int g = g0 + idx / C;
      const float v = lfs2::round_to<T>(lfs2::to_f(xs[idx]) + lfs2::to_f(as[idx]));
      xs[idx] = lfs2::from_f<T>(v);
      const float y = fmaxf(v, lfs2::round_to<T>(v * 0.2f));
      y1[idx] = (g >= 0 && g < L) ? lfs2::from_f<T>(y) : zero;
    }
    __syncthreads();

    // dilated conv, lane = output channel (each lane's channels co = lane,
    // lane + 32, ..), kConvRows rows a chunk. A chunk's last rows may lie
    // past b_hi and read up to kConvRows - 1 rows past the end of y1's
    // region: they lie inside y2's buffer and the results are dropped.
    for (int r0 = spec.b_lo[i] + warp * kConvRows; r0 < spec.b_hi[i];
         r0 += kWarps * kConvRows) {
#pragma unroll 1
      for (int co = lane; co < C; co += 32) {
        const T* w = conv_w + static_cast<long long>(i) * 3 * C * C + co;
        const float cb = conv_b[i * C + co];
        float acc[kConvRows];
#pragma unroll
        for (int rr = 0; rr < kConvRows; ++rr) acc[rr] = cb;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const T* src = y1 + (r0 + (j - 1) * d) * C;
          const T* wj = w + j * C * C;
#pragma unroll 4
          for (int ci0 = 0; ci0 < C; ci0 += 8) {
            float wv[8];
#pragma unroll
            for (int q = 0; q < 8; ++q) wv[q] = lfs2::to_f(wj[(ci0 + q) * C]);
#pragma unroll
            for (int rr = 0; rr < kConvRows; ++rr) {
              float yv[8];
              lfs2::load_vec<8>(src + rr * C + ci0, yv);
#pragma unroll
              for (int q = 0; q < 8; ++q) acc[rr] = fmaf(yv[q], wv[q], acc[rr]);
            }
          }
        }
#pragma unroll
        for (int rr = 0; rr < kConvRows; ++rr) {
          const int r = r0 + rr;
          if (r >= spec.b_hi[i]) break;
          const int g = g0 + r;
          const float v = fmaxf(acc[rr], acc[rr] * 0.2f);
          y2[r * C + co] = (g >= 0 && g < L) ? lfs2::from_f<T>(v) : zero;
        }
      }
    }
    __syncthreads();

    // LVC with the frame's own kernel and bias, then the gate. A chunk's RPT
    // rows start at a multiple of RPT and hop % RPT == 0, so they share one
    // frame and lie all inside [0, L) or all outside it.
    for (int r0 = spec.c_lo[i] + warp * RPT; r0 < spec.c_hi[i]; r0 += kWarps * RPT) {
      const int g = g0 + r0;
      if (g < 0 || g >= L) continue;
      const long long fi = (static_cast<long long>(b) * nL + g / hop) * spec.layers + i;
      const float* bs = bias + fi * (2 * C);
#pragma unroll 1
      for (int co = lane; co < C; co += 32) {
        const T* K = kern + fi * (C * 2 * C * 3) + co * 3;
        float acc_a[RPT], acc_b[RPT];
#pragma unroll
        for (int rr = 0; rr < RPT; ++rr) {
          acc_a[rr] = bs[co];
          acc_b[rr] = bs[co + C];
        }
#pragma unroll 1
        for (int ci0 = 0; ci0 < C; ci0 += 8) {
          float yv[RPT + 2][8];
#pragma unroll
          for (int q = 0; q < RPT + 2; ++q) lfs2::load_vec<8>(y2 + (r0 - 1 + q) * C + ci0, yv[q]);
#pragma unroll
          for (int cc = 0; cc < 8; ++cc) {
            const T* ka = K + (ci0 + cc) * (2 * C * 3);
            const T* kb = ka + C * 3;
            const float wa0 = lfs2::to_f(ka[0]), wa1 = lfs2::to_f(ka[1]), wa2 = lfs2::to_f(ka[2]);
            const float wb0 = lfs2::to_f(kb[0]), wb1 = lfs2::to_f(kb[1]), wb2 = lfs2::to_f(kb[2]);
#pragma unroll
            for (int rr = 0; rr < RPT; ++rr) {
              acc_a[rr] = fmaf(yv[rr][cc], wa0, acc_a[rr]);
              acc_a[rr] = fmaf(yv[rr + 1][cc], wa1, acc_a[rr]);
              acc_a[rr] = fmaf(yv[rr + 2][cc], wa2, acc_a[rr]);
              acc_b[rr] = fmaf(yv[rr][cc], wb0, acc_b[rr]);
              acc_b[rr] = fmaf(yv[rr + 1][cc], wb1, acc_b[rr]);
              acc_b[rr] = fmaf(yv[rr + 2][cc], wb2, acc_b[rr]);
            }
          }
        }
#pragma unroll
        for (int rr = 0; rr < RPT; ++rr) {
          T* xp = xs + (r0 + rr) * C + co;
          const float gv = lfs2::round_to<T>(gate<FAST>(acc_a[rr], acc_b[rr]));
          *xp = lfs2::from_f<T>(lfs2::to_f(*xp) + gv);
        }
      }
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < tile * C; idx += kThreads) {
    const int g = t0 + idx / C;
    if (g >= L) break;
    out[base + static_cast<long long>(g) * C + (idx % C)] = xs[spec.halo * C + idx];
  }
}

int floor_to(int v, int m) { return v >= 0 ? v / m * m : -((-v + m - 1) / m) * m; }

Spec make_spec(int layers, int tile) {
  Spec s = {};
  s.layers = layers;
  int lo = 0, hi = tile;  // rows relative to the tile's first
  int d = 1;
  for (int i = 1; i < layers; ++i) d *= 3;
  for (int i = layers - 1; i >= 0; --i, d /= 3) {
    s.c_lo[i] = floor_to(lo, kAlign);
    s.c_hi[i] = -floor_to(-hi, kAlign);
    s.b_lo[i] = s.c_lo[i] - 1;
    s.b_hi[i] = s.c_hi[i] + 1;
    s.a_lo[i] = s.b_lo[i] - d;
    s.a_hi[i] = s.b_hi[i] + d;
    lo = s.a_lo[i];
    hi = s.a_hi[i];
  }
  const int ext = -lo > hi - tile ? -lo : hi - tile;
  s.halo = -floor_to(-ext, kAlign);
  s.rows = tile + 2 * s.halo;
  for (int i = 0; i < layers; ++i) {
    s.a_lo[i] += s.halo; s.a_hi[i] += s.halo;
    s.b_lo[i] += s.halo; s.b_hi[i] += s.halo;
    s.c_lo[i] += s.halo; s.c_hi[i] += s.halo;
  }
  return s;
}

template <typename T, int C, int RPT, bool FAST>
cudaError_t launch(const Args& a, const Spec& spec, cudaStream_t stream) {
  const int smem = 4 * spec.rows * C * static_cast<int>(sizeof(T));
  auto kernel = lvc_stack_kernel<T, C, RPT, FAST>;
  cudaError_t err = lfs2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.L + a.tile - 1) / a.tile, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.ad), static_cast<const T*>(a.kern),
      a.bias, static_cast<const T*>(a.conv_w), a.conv_b, static_cast<T*>(a.out), a.L, a.hop,
      a.tile, spec);
  return record_launch(kRouteCores, a.tile, grid, smem, 0, 0, C);
}

template <typename T, int C>
cudaError_t dispatch(const Args& a, const Spec& spec, cudaStream_t s) {
  const bool quad = a.hop % kAlign == 0;
  if (a.fast)
    return quad ? launch<T, C, kAlign, true>(a, spec, s) : launch<T, C, 1, true>(a, spec, s);
  return quad ? launch<T, C, kAlign, false>(a, spec, s) : launch<T, C, 1, false>(a, spec, s);
}

// ===================== tensor-core route (hop % 8 == 0) ====================
constexpr int kConvTiles = 4;    // n8 row tiles of a conv chunk
constexpr int kMmaWarpsMax = 16;  // the most warps of a tensor-core block

// per working dtype and width: signal row stride (C + 16 bytes' worth: any 8
// rows fall in distinct bank groups for ldmatrix), the contraction, one
// frame's (C, 2C, 3) kernel of one layer, the staged weights' row strides
// (bf16 [k][out] frame kernels and [k][cout] conv taps; f32 split [out][k]),
// the channel groups, whether the weights are read from device memory
// (direct: no staged copy fits), the most n8 row tiles of an LVC chunk (acc
// registers: 2 CG / 16 m16 tiles x 4 floats each) and the threads
template <typename T, int C> struct Mma {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int LDY = C + 16 / static_cast<int>(sizeof(T));
  static constexpr int K = 3 * C;
  static constexpr int FRAME = C * 2 * C * 3;
  static constexpr int LDK = 2 * C + 8;
  static constexpr int LDW = C + 8;
  static constexpr int LDT = 3 * C + 4;
  static constexpr int CG = C < 32 ? C : 32;  // output channels of a group
  static constexpr int NG = C / CG;
  static constexpr int MTC = CG / 16;          // m16 tiles of a group's conv rows
  static constexpr bool DIRECT = BF16 ? C >= 128 : C >= 64;
  static constexpr int NT = BF16 ? 4 : 2;
  // bf16: 16 warps, four a scheduler, 128 registers a thread; f32: 8 warps
  // (the split products need more than 128 registers)
  static constexpr int THREADS = BF16 ? 512 : 256;
};

// Buffer rows (row 0 is signal position blockIdx.x * tile - halo) each
// layer computes: the dilated conv [b_lo, b_hi) and the LVC [c_lo, c_hi),
// exactly what the next step reads (no rounding); the halo is the chain's
// reach rounded up to 8, so that buffer rows and signal rows agree mod 8.
struct MmaSpec {
  int layers, halo, rows;
  int round_frames;  // frames whose kernels are staged at once (0: direct)
  int nt;            // n8 row tiles of an LVC chunk: 8 * nt rows of one frame
  int b_lo[kMaxLayers], b_hi[kMaxLayers];
  int c_lo[kMaxLayers], c_hi[kMaxLayers];
};

// leaky on two packed bf16: max(a, bf16(a * 0.2f)), the product in f32 and
// rounded once, as the plain version's bf16 x * 0.2
__device__ __forceinline__ uint32_t leaky2(uint32_t v) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 f = __bfloat1622float2(h);
  const __nv_bfloat162 r = __hmax2(h, __floats2bfloat162_rn(f.x * 0.2f, f.y * 0.2f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// ---- A operands: the weights (out, k) of an m16 tile whose first output is col
// bf16 staged [k][out] at stride lda in shared memory: ldmatrix.trans
struct SmemA {
  unsigned base;
  int lda;
  __device__ __forceinline__ void load(uint32_t (&a)[4], int col, int k0, int lane) const {
    const int r8 = lane & 7, j = lane >> 3;
    lfs2::ldmatrix_x4_trans(a, base + 2u * ((k0 + r8 + 8 * (j >> 1)) * lda + col + 8 * (j & 1)));
  }
};

// bf16 in device memory, A(m, k = tap C + cin) at w[cin sc + tap st + m sm]
// (conv taps: sc = C, st = C^2, sm = 1; a frame's kernel: sc = 6C, st = 1,
// sm = 3): scalar loads paired into the fragment's registers. k and k + 1
// (and k + 8, k + 9) share a tap, C being a multiple of 16.
template <int C> struct GlobalA {
  const unsigned short* w;
  int sc, st, sm;
  __device__ __forceinline__ void load(uint32_t (&a)[4], int col, int k0, int lane) const {
    const int g = lane >> 2, tq = lane & 3;
    const unsigned short* p = w + (k0 % C + 2 * tq) * sc + (k0 / C) * st + (col + g) * sm;
    const int o[4] = {0, 8 * sm, 8 * sc, 8 * sc + 8 * sm};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      a[q] = static_cast<uint32_t>(__ldg(p + o[q])) |
             (static_cast<uint32_t>(__ldg(p + o[q] + sc)) << 16);
  }
};

// f32 split, hi and lo halves staged [out][k] at stride LDT: ldmatrix gives
// a thread its A fragment (a b16 8 x 8 matrix is an 8 x 4 block of 32-bit
// values)
template <int LDT> struct SmemSplitA {
  unsigned hi, lo;
  __device__ __forceinline__ void load(uint32_t (&ah)[4], uint32_t (&al)[4], int col, int k0,
                                       int lane) const {
    const int r8 = lane & 7, j = lane >> 3;
    const unsigned off = 4u * ((col + r8 + 8 * (j & 1)) * LDT + k0 + 4 * (j >> 1));
    lfs2::ldmatrix_x4(ah, hi + off);
    lfs2::ldmatrix_x4(al, lo + off);
  }
};

// f32 in device memory (GlobalA's layout), split in registers
template <int C> struct GlobalSplitA {
  const float* w;
  int sc, st, sm;
  __device__ __forceinline__ void load(uint32_t (&ah)[4], uint32_t (&al)[4], int col, int k0,
                                       int lane) const {
    const int g = lane >> 2, tq = lane & 3;
    const float* p = w + (k0 % C + tq) * sc + (k0 / C) * st + (col + g) * sm;
    lfs2::split_a(__ldg(p), __ldg(p + 8 * sm), __ldg(p + 4 * sc), __ldg(p + 4 * sc + 8 * sm), ah,
                  al);
  }
};

// acc[mt][nt] (m16 tile mt of MT, n8 row tile nt of NT) += the products of
// one chunk: A = the weights (wa), m16 tile mt's first output col0 + 16 (mt
// % H) + (mt / H) hstride (an LVC group: H sigmoid tiles, then H tanh tiles
// hstride = C further), B = signal rows s + 8 nt + shift(tap) of src,
// clamped to the buffer (a clamped row feeds only a row the epilogue
// drops). n8 tiles past n_act issue nothing. LEAKY applies the leaky to B
// (the conv reads x). bf16: m16n8k16, B through ldmatrix.
template <int MT, int H, int NT, int LDY, int C, bool LEAKY, class A>
__device__ __forceinline__ void products(float (&acc)[MT][NT][4], const A& wa, int col0,
                                         int hstride, const __nv_bfloat16* src, int s, int n_act,
                                         int d, int rows, int lane) {
  const unsigned y_base = lfs2::smem_u32(src);
  const int r8 = lane & 7, j = lane >> 3;
  constexpr int kSteps = 3 * C / 16, kUnroll = C <= 32 ? kSteps : 2;
#pragma unroll (kUnroll)
  for (int ks = 0; ks < kSteps; ++ks) {
    const int k0 = 16 * ks, tap = k0 / C, cin0 = k0 % C;
    const int shift = (tap - 1) * d;
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) wa.load(a[mt], col0 + 16 * (mt % H) + (mt / H) * hstride, k0, lane);
    uint32_t b[NT][2];
#pragma unroll
    for (int np = 0; np < (NT + 1) / 2; ++np) {
      if (2 * np >= n_act) continue;
      const int row = min(max(s + 16 * np + 8 * (j >> 1) + r8 + shift, 0), rows - 1);
      uint32_t r[4];
      lfs2::ldmatrix_x4(r, y_base + 2u * (row * LDY + cin0 + 8 * (j & 1)));
      if (LEAKY) {
#pragma unroll
        for (int q = 0; q < 4; ++q) r[q] = leaky2(r[q]);
      }
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      if (2 * np + 1 < NT) {
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt >= n_act) continue;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) lfs2::mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
  }
}

// f32: the weights come split (SmemSplitA or GlobalSplitA); B is split in
// registers.
template <int MT, int H, int NT, int LDY, int C, bool LEAKY, class A>
__device__ __forceinline__ void products(float (&acc)[MT][NT][4], const A& wa, int col0,
                                         int hstride, const float* src, int s, int n_act, int d,
                                         int rows, int lane) {
  const unsigned y_base = lfs2::smem_u32(src);
  const int r8 = lane & 7, j = lane >> 3;
#pragma unroll 2
  for (int ks = 0; ks < 3 * C / 8; ++ks) {
    const int k0 = 8 * ks, tap = k0 / C, cin0 = k0 % C;
    const int shift = (tap - 1) * d;
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      wa.load(ah[mt], al[mt], col0 + 16 * (mt % H) + (mt / H) * hstride, k0, lane);
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int np = 0; np < (NT + 1) / 2; ++np) {
      if (2 * np >= n_act) continue;
      const int row = min(max(s + 16 * np + 8 * (j >> 1) + r8 + shift, 0), rows - 1);
      uint32_t r[4];
      lfs2::ldmatrix_x4(r, y_base + 4u * (row * LDY + cin0 + 4 * (j & 1)));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (2 * np + (q >> 1) >= NT) continue;
        float v = __uint_as_float(r[q]);
        if (LEAKY) v = fmaxf(v, v * 0.2f);
        lfs2::split(v, bh[2 * np + (q >> 1)][q & 1], bl[2 * np + (q >> 1)][q & 1]);
      }
    }
    // the three products of every accumulator in three passes (hi lo, lo
    // hi, hi hi: mma3's order), so that consecutive MMAs are independent
#pragma unroll
    for (int pass = 0; pass < 3; ++pass)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt >= n_act) continue;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          lfs2::mma_tf32(acc[mt][nt], pass == 1 ? al[mt] : ah[mt], pass == 0 ? bl[nt] : bh[nt]);
      }
  }
}

// f32 at one n8 row tile a frame (a hop that is not a multiple of 16): the
// LVC product straight from the frame's raw (cin, out, tap) kernel as it
// landed, for the gate pair of m16 tiles {h2, h2 + C / 16}. The
// contraction runs in the raw order k = cin * 3 + tap (any order serves
// when A and B agree), so a lane's A values of one k-step lie at most two
// banks apart; A and B come by scalar loads and are split in registers.
template <int LDY, int C>
__device__ __forceinline__ void raw_products(float (&acc)[2][4], const float* K, int h2,
                                             const float* src, int s, int rows, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll 2
  for (int ks = 0; ks < 3 * C / 8; ++ks) {
    const int k0 = 8 * ks + tq, k1 = k0 + 4;
    const int cin0 = k0 / 3, tap0 = k0 - 3 * cin0, cin1 = k1 / 3, tap1 = k1 - 3 * cin1;
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int m = 16 * h2 + C * mt + g;
      const float* k0p = K + (cin0 * 2 * C + m) * 3 + tap0;
      const float* k1p = K + (cin1 * 2 * C + m) * 3 + tap1;
      lfs2::split(k0p[0], ah[mt][0], al[mt][0]);
      lfs2::split(k0p[24], ah[mt][1], al[mt][1]);
      lfs2::split(k1p[0], ah[mt][2], al[mt][2]);
      lfs2::split(k1p[24], ah[mt][3], al[mt][3]);
    }
    const int row0 = min(max(s + g + tap0 - 1, 0), rows - 1);
    const int row1 = min(max(s + g + tap1 - 1, 0), rows - 1);
    uint32_t bh[2], bl[2];
    lfs2::split(src[row0 * LDY + cin0], bh[0], bl[0]);
    lfs2::split(src[row1 * LDY + cin1], bh[1], bl[1]);
#pragma unroll
    for (int pass = 0; pass < 3; ++pass)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        lfs2::mma_tf32(acc[mt], pass == 1 ? al[mt] : ah[mt], pass == 0 ? bl : bh);
  }
}

// ---- phase clocks (built with LFS2_LVC_PHASE_CLOCKS only) -------------------
// The middle block of batch item 0 adds, per warp, the cycles of each phase
// in registers (slots are constants) and, at the end, into
// g_phase[warp][slot]; lfs2_lvc_stack_phase_clocks copies them out. Slots:
// 0 loads, 1 waiting for a round's copies, 2 reordering a round's kernels
// and issuing the next, 3 conv, 4 waiting for the conv, 5 LVC products, 6
// LVC epilogues, 7 the final barrier and the output.
#ifdef LFS2_LVC_PHASE_CLOCKS
__device__ long long g_phase[kMmaWarpsMax][8];
#define LVC_CLOCK(var)                                                  \
  long long var = clock64();                                            \
  long long lvc_phase_[8] = {}
#define LVC_PHASE(slot, since)                                          \
  do {                                                                  \
    const long long now_ = clock64();                                   \
    lvc_phase_[slot] += now_ - since;                                   \
    since = now_;                                                       \
  } while (0)
#define LVC_FLUSH()                                                     \
  do {                                                                  \
    if (blockIdx.x == gridDim.x / 2 && blockIdx.y == 0 && (threadIdx.x & 31) == 0) \
      for (int i_ = 0; i_ < 8; ++i_) g_phase[threadIdx.x >> 5][i_] = lvc_phase_[i_]; \
    if (blockIdx.x == gridDim.x / 2 && blockIdx.y == 0 && threadIdx.x == 0) \
      for (int w_ = blockDim.x >> 5; w_ < kMmaWarpsMax; ++w_)           \
        for (int i_ = 0; i_ < 8; ++i_) g_phase[w_][i_] = 0;             \
  } while (0)
#else
#define LVC_CLOCK(var)
#define LVC_PHASE(slot, since)
#define LVC_FLUSH()
#endif

// One launch runs every layer for a tile of rows, in the transposed form:
// out^T (channels x rows) = W^T (channels x 3C) @ rows^T (3C x rows), n8
// row tiles (see the note at the top of this file). Each step's n8 tiles
// are split evenly over the warps, each warp taking a contiguous run of
// them in chunks of up to NT tiles (an LVC chunk never crosses a frame),
// every channel group of a chunk in turn.
template <typename T, int C, bool FAST>
__global__ void __launch_bounds__(Mma<T, C>::THREADS, 1)
lvc_mma_kernel(const T* __restrict__ x, const T* __restrict__ ad, const T* __restrict__ kern,
               const float* __restrict__ bias, const T* __restrict__ conv_w,
               const float* __restrict__ conv_b, T* __restrict__ out, int L, int hop, int tile,
               const __grid_constant__ MmaSpec sp) {
  using G = Mma<T, C>;
  constexpr int LDY = G::LDY;
  constexpr int NTL = G::NT;
  constexpr int kMmaThreads = G::THREADS;
  constexpr int kMmaWarps = kMmaThreads / 32;
  constexpr int V = 16 / sizeof(T);           // elements in 16 bytes
  constexpr int kRowPieces = C / V;           // 16-byte pieces of a signal row
  constexpr int kFramePieces = G::FRAME / V;
  constexpr bool kSplit = !G::BF16;           // f32: split-TF32 products
  constexpr int CG = G::CG, NG = G::NG, MTC = G::MTC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int R = sp.rows, FR = sp.round_frames;
  T* xs = reinterpret_cast<T*>(smem_raw);     // x (after this layer's residual add)
  T* as = xs + R * LDY;                       // audio_down
  T* y2 = as + R * LDY;                       // the LVC's input
  // Then, staged, the weights. bf16: the layer's conv taps [k][cout], the
  // round's frame kernels [k][out], the next round's raw frame kernels
  // (stg). f32: the conv taps split, hi then lo halves, each [out][k] (wh,
  // wl); with nt > 1 the round's frame kernels split the same way (kf), the
  // next round's raw ones waiting in registers (pre), for want of room; with
  // one n8 tile a chunk (a hop that is not a multiple of 16) no kf: the LVC
  // reads each frame's kernel raw (raw_products) from two slots of bulk
  // copies by round parity, since a split or reordered copy would serve one
  // tile. Direct: nothing past y2.
  const bool presplit = kSplit && !G::DIRECT && sp.nt > 1;
  const bool raw = kSplit && !G::DIRECT && !presplit;
  const int kf_elems = kSplit ? (presplit ? 2 * 2 * C * G::LDT : 0) : G::K * G::LDK;
  T* cw = y2 + R * LDY;
  T* kf = cw + (kSplit ? 2 * C * G::LDT : G::K * G::LDW);
  T* stg = kf + FR * kf_elems;
  // one mbarrier a staging slot (two slots on the raw route, none with
  // split kernels): a round's frames land by bulk copies
  const unsigned bars = lfs2::smem_u32(stg + (raw ? 2 : presplit ? 0 : 1) * FR * G::FRAME);
  float* wh = reinterpret_cast<float*>(cw);
  float* wl = wh + C * G::LDT;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int g0 = t0 - sp.halo;                // signal position of buffer row 0
  const int nL = L / hop;
  const long long base = static_cast<long long>(b) * L * C;
  const T* kb = kern + static_cast<long long>(b) * nL * sp.layers * G::FRAME;
  const float* bb = bias + static_cast<long long>(b) * nL * sp.layers * 2 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  // frames [fa, fb) holding the signal rows of layer i's LVC
  auto layer_frames = [&](int i, int& fa, int& fb) {
    const int lo = g0 + sp.c_lo[i];
    fa = lo <= 0 ? 0 : lo / hop;
    fb = min(nL, (g0 + sp.c_hi[i] - 1) / hop + 1);
  };
  // f32: layer i's conv taps (k, cout), split, into wh and wl as [cout][k]
  auto split_conv = [&](int i) {
    const float* src = reinterpret_cast<const float*>(conv_w) + static_cast<long long>(i) * G::K * C;
    for (int idx = threadIdx.x; idx < G::K * C; idx += kMmaThreads) {
      const int k = idx / C, co = idx % C;
      uint32_t hi, lo;
      lfs2::split(src[idx], hi, lo);
      wh[co * G::LDT + k] = __uint_as_float(hi);
      wl[co * G::LDT + k] = __uint_as_float(lo);
    }
  };
  // round r of layer i into staging slot `slot`: its frames' raw kernels
  // (each contiguous: one bulk copy a frame by thread 0, counted on the
  // slot's mbarrier), and in bf16 with r == 0 the layer's conv taps (one
  // cp.async commit group)
  auto issue = [&](int i, int r, int slot) {
    if (threadIdx.x == 0) {
      int fa, fb;
      layer_frames(i, fa, fb);
      const int f0 = fa + r * FR, nf = min(FR, fb - f0);
      const unsigned bytes = G::FRAME * sizeof(T), bar = bars + 8u * slot;
      const unsigned dst = lfs2::smem_u32(stg + slot * FR * G::FRAME);
      const T* src = kb + (static_cast<long long>(f0) * sp.layers + i) * G::FRAME;
      lfs2::mbar_expect_tx(bar, nf * bytes);
      for (int jf = 0; jf < nf; ++jf)
        lfs2::bulk_load(dst + jf * bytes, src + static_cast<long long>(jf) * sp.layers * G::FRAME,
                        bytes, bar);
    }
    if (r == 0 && !kSplit) {
      T* cdst = cw;
      const T* wsrc = conv_w + static_cast<long long>(i) * G::K * C;
      for (int idx = threadIdx.x; idx < G::K * kRowPieces; idx += kMmaThreads) {
        const int k = idx / kRowPieces, p = (idx - k * kRowPieces) * V;
        lfs2::cp_async16(cdst + k * G::LDW + p, wsrc + k * C + p);
      }
    }
    lfs2::cp_async_commit();
  };

  // f32 with split kernels: round r of layer i's raw kernels into pre, one
  // 16-byte piece a thread per kMmaThreads (two frames at most: kPre pieces)
  constexpr int kPre = kSplit && !G::DIRECT ? 2 * kFramePieces / kMmaThreads : 1;
  float4 pre[kPre];
  auto prefetch = [&](int i, int r) {
    int fa, fb;
    layer_frames(i, fa, fb);
    const int f0 = fa + r * FR, n_pieces = min(FR, fb - f0) * kFramePieces;
    const float* src = reinterpret_cast<const float*>(kb) +
                       (static_cast<long long>(f0) * sp.layers + i) * G::FRAME;
#pragma unroll
    for (int t = 0; t < kPre; ++t) {
      const int idx = threadIdx.x + t * kMmaThreads;
      if (idx >= n_pieces) break;
      const int jf = idx / kFramePieces, p = (idx - jf * kFramePieces) * V;
      pre[t] = *reinterpret_cast<const float4*>(
          src + static_cast<long long>(jf) * sp.layers * G::FRAME + p);
    }
  };

  // the dilated conv of layer i over [b_lo, b_hi) with the taps wa: y2 =
  // round(leaky(conv(leaky(x)) + conv_b)), zero outside [0, L)
  auto conv = [&](int i, int d, const auto& wa) {
    const int lo = sp.b_lo[i], hi = sp.b_hi[i];
    const int first = lo & ~7, n_tiles = (hi - first + 7) / 8;
    const int u1 = n_tiles * (warp + 1) / kMmaWarps;
    for (int u = n_tiles * warp / kMmaWarps; u < u1; u += kConvTiles) {
      const int s = first + 8 * u, n_act = min(kConvTiles, u1 - u);
#pragma unroll 1
      for (int grp = 0; grp < NG; ++grp) {
        float cb[MTC][2];
#pragma unroll
        for (int mt = 0; mt < MTC; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) cb[mt][h] = conv_b[i * C + grp * CG + 16 * mt + g + 8 * h];
        float acc[MTC][kConvTiles][4] = {};
        products<MTC, MTC, kConvTiles, LDY, C, true>(acc, wa, grp * CG, 0, xs, s, n_act, d, R,
                                                     lane);
#pragma unroll
        for (int nt = 0; nt < kConvTiles; ++nt) {
          if (nt >= n_act) continue;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int row = s + 8 * nt + 2 * tq + c;
            if (row < lo || row >= hi) continue;
            const bool inside = g0 + row >= 0 && g0 + row < L;
            T* yr = y2 + row * LDY + grp * CG + g;
#pragma unroll
            for (int mt = 0; mt < MTC; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float v = acc[mt][nt][2 * h + c] + cb[mt][h];
                yr[16 * mt + 8 * h] = lfs2::from_f<T>(inside ? fmaxf(v, v * 0.2f) : 0.0f);
              }
          }
        }
      }
    }
  };

  // x = round(x + round(gate(a, b))) (then + ad, rounded, but in the last layer)
  auto gate_into_x = [&](bool last, T* xp, const T* ap, float a, float bg) {
    float v = lfs2::round_to<T>(lfs2::to_f(*xp) + lfs2::round_to<T>(gate<FAST>(a, bg)));
    if (!last) v = lfs2::round_to<T>(v + lfs2::to_f(*ap));
    *xp = lfs2::from_f<T>(v);
  };

  LVC_CLOCK(tp);
  // the LVC of layer i on n_act n8 tiles from row s, all in frame f, with
  // the frame's kernel (wa) and bias: the gate, the residual add (and the
  // next layer's x + ad) into the rows of [rlo, rhi)
  auto lvc = [&](int i, bool last, int s, int n_act, int f, int rlo, int rhi, const auto& wa) {
    const float* bs = bb + (static_cast<long long>(f) * sp.layers + i) * 2 * C;
#pragma unroll 1
    for (int grp = 0; grp < NG; ++grp) {
      float ba[MTC][2], bg[MTC][2];
#pragma unroll
      for (int mt = 0; mt < MTC; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          ba[mt][h] = bs[grp * CG + 16 * mt + g + 8 * h];
          bg[mt][h] = bs[C + grp * CG + 16 * mt + g + 8 * h];
        }
      float acc[2 * MTC][NTL][4] = {};
      products<2 * MTC, MTC, NTL, LDY, C, false>(acc, wa, grp * CG, C, y2, s, n_act, 1, R, lane);
      LVC_PHASE(5, tp);
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt) {
        if (nt >= n_act) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int row = s + 8 * nt + 2 * tq + c;
          if (row < rlo || row >= rhi) continue;
          T* xr = xs + row * LDY + grp * CG + g;
          const T* ar = as + row * LDY + grp * CG + g;
#pragma unroll
          for (int mt = 0; mt < MTC; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              gate_into_x(last, xr + 16 * mt + 8 * h, ar + 16 * mt + 8 * h,
                          acc[mt][nt][2 * h + c] + ba[mt][h],
                          acc[mt + MTC][nt][2 * h + c] + bg[mt][h]);
        }
      }
      LVC_PHASE(6, tp);
    }
  };

  if (!G::DIRECT && threadIdx.x == 0) {
    lfs2::mbar_init(bars, 1);
    lfs2::mbar_init(bars + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (!G::DIRECT) {
    if (kSplit) split_conv(0);
    if (presplit)
      prefetch(0, 0);
    else
      issue(0, 0, 0);
  }
  // x and audio_down rows through cp.async (zero outside [0, L)), with the
  // first round's copies; then xs = x + ad, layer 0's residual add
  for (int idx = threadIdx.x; idx < R * kRowPieces; idx += kMmaThreads) {
    const int row = idx / kRowPieces, p = (idx - row * kRowPieces) * V;
    const int gp = g0 + row;
    if (gp >= 0 && gp < L) {
      lfs2::cp_async16(xs + row * LDY + p, x + base + static_cast<long long>(gp) * C + p);
      lfs2::cp_async16(as + row * LDY + p, ad + base + static_cast<long long>(gp) * C + p);
    } else {
      *reinterpret_cast<uint4*>(xs + row * LDY + p) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(as + row * LDY + p) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  lfs2::cp_async_commit();
  lfs2::cp_async_wait_all();
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * kRowPieces; idx += kMmaThreads) {
    const int row = idx / kRowPieces, p = (idx - row * kRowPieces) * V;
    uint4 xv = *reinterpret_cast<const uint4*>(xs + row * LDY + p);
    const uint4 av = *reinterpret_cast<const uint4*>(as + row * LDY + p);
    T* xe = reinterpret_cast<T*>(&xv);
    const T* ae = reinterpret_cast<const T*>(&av);
#pragma unroll
    for (int e = 0; e < V; ++e) xe[e] = lfs2::from_f<T>(lfs2::to_f(xe[e]) + lfs2::to_f(ae[e]));
    *reinterpret_cast<uint4*>(xs + row * LDY + p) = xv;
  }

  if constexpr (G::DIRECT) {
    // every layer's weights straight from device memory: the conv over its
    // rows, then the LVC over the rows inside [0, L), chunks cut at frames
    int d = 1;
    for (int i = 0; i < sp.layers; ++i, d *= 3) {
      __syncthreads();  // x is whole (the previous layer's LVC, or the loads)
      if constexpr (kSplit)
        conv(i, d, GlobalSplitA<C>{reinterpret_cast<const float*>(conv_w) + i * G::K * C, C, C * C, 1});
      else
        conv(i, d, GlobalA<C>{reinterpret_cast<const unsigned short*>(conv_w) + i * G::K * C, C,
                              C * C, 1});
      __syncthreads();  // y2 is whole
      const bool last = i == sp.layers - 1;
      const int rlo = max(sp.c_lo[i], -g0), rhi = min(sp.c_hi[i], L - g0);
      const int first = rlo & ~7, n_tiles = max(0, (rhi - first + 7) / 8);
      const int u1 = n_tiles * (warp + 1) / kMmaWarps;
      for (int u = n_tiles * warp / kMmaWarps; u < u1;) {
        const int s = first + 8 * u;
        const int f = (g0 + s) / hop;
        const int n_act = min(min(sp.nt, u1 - u), ((f + 1) * hop - g0 - s) / 8);
        const long long fo = (static_cast<long long>(f) * sp.layers + i) * G::FRAME;
        if constexpr (kSplit)
          lvc(i, last, s, n_act, f, rlo, rhi,
              GlobalSplitA<C>{reinterpret_cast<const float*>(kb) + fo, 6 * C, 1, 3});
        else
          lvc(i, last, s, n_act, f, rlo, rhi,
              GlobalA<C>{reinterpret_cast<const unsigned short*>(kb) + fo, 6 * C, 1, 3});
        u += n_act;
      }
    }
  } else {
    int q = 0;  // rounds so far: a raw slot's parity
    int d = 1;
    for (int i = 0; i < sp.layers; ++i, d *= 3) {
      int fa, fb;
      layer_frames(i, fa, fb);
      const int n_rounds = (fb - fa + FR - 1) / FR;
      const bool last = i == sp.layers - 1;
      for (int r = 0; r < n_rounds; ++r, ++q) {
        LVC_PHASE(0, tp);
        lfs2::cp_async_wait_all();
        if (!presplit) {  // the round's frames: slot q % slots, its (q / slots)-th use
          const int slots = raw ? 2 : 1;
          lfs2::mbar_wait(bars + 8u * (q % slots), (q / slots) & 1);
        }
        __syncthreads();  // the round's copies landed; every warp is done with kf and y2
        LVC_PHASE(1, tp);
        const int f0 = fa + r * FR, nf = min(FR, fb - f0);
        const bool more = r + 1 < n_rounds || !last;  // a round follows
        const int ni = r + 1 < n_rounds ? i : i + 1, nr = r + 1 < n_rounds ? r + 1 : 0;
        if (raw && more) issue(ni, nr, (q + 1) & 1);  // the other slot: its round is done
        if constexpr (kSplit) {
          // f32 with split kernels: the round's raw (cin, out, tap) kernels
          // from pre, 16 bytes a piece, split into kf's hi and lo halves at
          // [out][tap * C + cin] (the raw route reads them as they landed)
          if (presplit) {
            float* kh = reinterpret_cast<float*>(kf);
            const int n_pieces = nf * kFramePieces;
#pragma unroll
            for (int t = 0; t < kPre; ++t) {
              const int idx = threadIdx.x + t * kMmaThreads;
              if (idx >= n_pieces) break;
              const int jf = idx / kFramePieces, p = (idx - jf * kFramePieces) * V;
              const float ve[4] = {pre[t].x, pre[t].y, pre[t].z, pre[t].w};
              const int cin = p / (2 * C * 3), o3 = p - cin * (2 * C * 3);
              float* dh = kh + jf * kf_elems + cin;
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int o = (o3 + e) / 3, tap = o3 + e - 3 * o;
                uint32_t hi, lo;
                lfs2::split(ve[e], hi, lo);
                dh[o * G::LDT + tap * C] = __uint_as_float(hi);
                dh[(2 * C + o) * G::LDT + tap * C] = __uint_as_float(lo);
              }
            }
          }
        } else {
          // bf16: raw (cin, out, tap) -> kf[tap * C + cin][out]: a thread
          // moves the three taps of one (cin, out)
          const T* src = stg;
#pragma unroll 4
          for (int idx = threadIdx.x; idx < nf * C * 2 * C; idx += kMmaThreads) {
            const int jf = idx / (2 * C * C), cin = (idx / (2 * C)) % C, o = idx % (2 * C);
            const T* sp3 = src + jf * G::FRAME + (cin * 2 * C + o) * 3;
            T* dst = kf + jf * G::K * G::LDK + cin * G::LDK + o;
            const T v0 = sp3[0], v1 = sp3[1], v2 = sp3[2];
            dst[0] = v0;
            dst[C * G::LDK] = v1;
            dst[2 * C * G::LDK] = v2;
          }
        }
        LVC_PHASE(2, tp);

        if (r == 0) {
          if constexpr (kSplit)
            conv(i, d, SmemSplitA<G::LDT>{lfs2::smem_u32(wh), lfs2::smem_u32(wl)});
          else
            conv(i, d, SmemA{lfs2::smem_u32(cw), G::LDW});
        }
        LVC_PHASE(3, tp);
        if (r == 0 || !raw) __syncthreads();  // y2 and the round's kf are whole; stg, cw free
        // the next round's copies (or the next layer's first), under this LVC;
        // f32 splits the next layer's conv taps here
        if (kSplit && r + 1 == n_rounds && !last) split_conv(i + 1);
        if (more && presplit) prefetch(ni, nr);
        if (more && !kSplit) issue(ni, nr, 0);
        LVC_PHASE(4, tp);

        // LVC of the round's rows with each frame's kernel and bias, the
        // gate, the residual add (and the next layer's x + ad). The round's
        // n8 tiles start at a multiple of 8 in the signal, and so do frames
        // (hop % 8 == 0): a chunk is cut at a frame's end.
        const int rlo = max(sp.c_lo[i], f0 * hop - g0);
        const int rhi = min(sp.c_hi[i], (f0 + nf) * hop - g0);
        const int first = rlo & ~7, n_tiles = (rhi - first + 7) / 8;
        if constexpr (kSplit) {
          if (raw) {
            // f32, one row tile a frame: C / 16 units a tile, the gate pairs
            // of m16 tiles {h, h + C / 16}, so that more warps share a round
            constexpr int NH = C / 16;
            const int n_units = NH * n_tiles;
            for (int u = warp; u < n_units; u += kMmaWarps) {
              const int s = first + 8 * (u / NH), h2 = u % NH;
              const int f = (g0 + s) / hop;
              const float* bs = bb + (static_cast<long long>(f) * sp.layers + i) * 2 * C;
              float ba[2], bg[2];
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                ba[h] = bs[16 * h2 + g + 8 * h];
                bg[h] = bs[C + 16 * h2 + g + 8 * h];
              }
              float acc[2][4] = {};
              raw_products<LDY, C>(acc, reinterpret_cast<const float*>(stg) +
                                           ((q & 1) * FR + f - f0) * G::FRAME,
                                   h2, y2, s, R, lane);
              LVC_PHASE(5, tp);
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int row = s + 2 * tq + c;
                if (row < rlo || row >= rhi) continue;
                T* xr = xs + row * LDY + 16 * h2 + g;
                const T* ar = as + row * LDY + 16 * h2 + g;
#pragma unroll
                for (int h = 0; h < 2; ++h)
                  gate_into_x(last, xr + 8 * h, ar + 8 * h, acc[0][2 * h + c] + ba[h],
                              acc[1][2 * h + c] + bg[h]);
              }
              LVC_PHASE(6, tp);
            }
            continue;
          }
        }
        const int u1 = n_tiles * (warp + 1) / kMmaWarps;
        for (int u = n_tiles * warp / kMmaWarps; u < u1;) {
          const int s = first + 8 * u;
          const int f = (g0 + s) / hop;
          const int n_act = min(min(sp.nt, u1 - u), ((f + 1) * hop - g0 - s) / 8);
          if constexpr (kSplit) {
            const float* kh = reinterpret_cast<const float*>(kf) + (f - f0) * kf_elems;
            lvc(i, last, s, n_act, f, rlo, rhi,
                SmemSplitA<G::LDT>{lfs2::smem_u32(kh), lfs2::smem_u32(kh + 2 * C * G::LDT)});
          } else {
            lvc(i, last, s, n_act, f, rlo, rhi,
                SmemA{lfs2::smem_u32(kf + (f - f0) * G::K * G::LDK), G::LDK});
          }
          u += n_act;
        }
      }
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < tile * kRowPieces; idx += kMmaThreads) {
    const int row = idx / kRowPieces, p = (idx - row * kRowPieces) * V;
    const int gp = t0 + row;
    if (gp >= L) break;
    *reinterpret_cast<uint4*>(out + base + static_cast<long long>(gp) * C + p) =
        *reinterpret_cast<const uint4*>(xs + (sp.halo + row) * LDY + p);
  }
  LVC_PHASE(7, tp);
  LVC_FLUSH();
}

int ceil_to(int v, int m) { return (v + m - 1) / m * m; }

MmaSpec make_mma_spec(int layers, int tile, int round_frames, int nt) {
  MmaSpec s = {};
  s.layers = layers;
  s.round_frames = round_frames;
  s.nt = nt;
  int lo = 0, hi = tile;  // rows relative to the tile's first
  int d = 1;
  for (int i = 1; i < layers; ++i) d *= 3;
  for (int i = layers - 1; i >= 0; --i, d /= 3) {
    s.c_lo[i] = lo;
    s.c_hi[i] = hi;
    s.b_lo[i] = lo - 1;
    s.b_hi[i] = hi + 1;
    lo = s.b_lo[i] - d;
    hi = s.b_hi[i] + d;
  }
  s.halo = ceil_to(-lo, 8);
  s.rows = tile + 2 * s.halo;
  for (int i = 0; i < layers; ++i) {
    s.b_lo[i] += s.halo; s.b_hi[i] += s.halo;
    s.c_lo[i] += s.halo; s.c_hi[i] += s.halo;
  }
  return s;
}

// shared-memory bytes of a tensor-core launch (ops/fastdiff_lvc.py
// mma_smem_bytes computes the same): two mbarriers and the x, audio_down
// and y2 rows; staged bf16 the conv taps and per staged frame its kernel in
// [k][out] order and its raw copy; staged f32 the split conv taps and per
// frame its split kernel (nt > 1) or two raw copies (nt == 1); direct
// nothing more
template <typename T, int C> int mma_smem_bytes(int rows, int round_frames, int nt) {
  using G = Mma<T, C>;
  constexpr int kBars = 16;  // two mbarriers
  const int signal = 3 * rows * G::LDY * static_cast<int>(sizeof(T));
  if (G::DIRECT) return kBars + signal;
  if (G::BF16) return kBars + signal + 2 * (G::K * G::LDW + round_frames * (G::K * G::LDK + G::FRAME));
  return kBars + signal +
         4 * (2 * C * G::LDT + round_frames * (nt > 1 ? 2 * 2 * C * G::LDT : 2 * G::FRAME));
}

template <typename T, int C, bool FAST>
cudaError_t mma_launch(const Args& a, const MmaSpec& spec, int smem, cudaStream_t stream) {
  auto kernel = lvc_mma_kernel<T, C, FAST>;
  cudaError_t err = lfs2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.L + a.tile - 1) / a.tile, a.B);
  kernel<<<grid, Mma<T, C>::THREADS, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.ad), static_cast<const T*>(a.kern),
      a.bias, static_cast<const T*>(a.conv_w), a.conv_b, static_cast<T*>(a.out), a.L, a.hop,
      a.tile, spec);
  return record_launch(Mma<T, C>::DIRECT ? kRouteDirect : kRouteMma, a.tile, grid, smem,
                       spec.round_frames, spec.nt, C);
}

// one launch at width C: the CUDA cores (route 0) or the tensor cores
// (route 1 staged, route 2 direct: the one Mma<T, C> takes)
template <typename T, int C>
cudaError_t run(const Args& a, cudaStream_t s) {
  if (a.route == kRouteCores) {
    if (a.tile < kAlign || a.tile % kAlign != 0) return cudaErrorInvalidValue;
    const Spec spec = make_spec(a.layers, a.tile);
    if (4 * spec.rows * C * static_cast<int>(sizeof(T)) > kMaxSmem) return cudaErrorInvalidValue;
    return dispatch<T, C>(a, spec, s);
  }
  using G = Mma<T, C>;
  if (a.route != (G::DIRECT ? kRouteDirect : kRouteMma) || a.hop % 8 != 0 || a.tile < 8 ||
      a.tile % 8 != 0 || (a.nt != 1 && a.nt != 2 && a.nt != 4) || a.nt > G::NT ||
      a.hop % (8 * a.nt) != 0 || (G::DIRECT ? a.round_frames != 0 : a.round_frames < 1) ||
      (!G::BF16 && !G::DIRECT && a.nt > 1 && a.round_frames > 2))
    return cudaErrorInvalidValue;
  const MmaSpec spec = make_mma_spec(a.layers, a.tile, a.round_frames, a.nt);
  const int smem = mma_smem_bytes<T, C>(spec.rows, a.round_frames, a.nt);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  return a.fast ? mma_launch<T, C, true>(a, spec, smem, s) : mma_launch<T, C, false>(a, spec, smem, s);
}

template <typename T>
cudaError_t run_width(int C, const Args& a, cudaStream_t s) {
  switch (C) {
    case 16: return run<T, 16>(a, s);
    case 32: return run<T, 32>(a, s);
    case 64: return run<T, 64>(a, s);
    case 128: return run<T, 128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// ============================ wide route (C > 128) ==========================
// Past C = 128 neither a fused tile nor one frame's staged kernel fits a
// block (a frame's kernel of one layer is 6 C^2 values: 786 KB in bf16 at C
// = 256), and the frame kernels are the launch's traffic whatever the hop.
// So the chain runs one layer at a time, two launches a layer, x kept in
// device memory (out) and the conv's output y in a (B, L, Cp) scratch of
// the working dtype; Cp is C rounded up to 16 (the wrapper zero-pads x, ad,
// the conv's taps and bias; the frame kernels and biases are read at the
// real C, masked, and never copied).
//   conv: y = round(leaky(conv3_d(leaky(round(x + ad))) + conv_b)), an
// implicit GEMM on csrc/gemm_mma.cuh (M = B L rows, N = Cp, K = 3 Cp in the
// order tap * Cp + cin; A gathered from x and ad by WideConvRows, B the
// taps as they lie, the output columns past Cp masked).
//   LVC (lvc_wide_kernel): a block takes 64 rows of one frame by 128 gate
// columns, i.e. 256 product columns: the sigmoid half's c and the tanh
// half's C + c side by side in each warp's n-tiles, so a thread holds both
// halves of its gates (hop 8 or 50 leave rows of the tile unused). K = 3 C
// in the order cin * 3 + tap: for one input channel a run of output columns
// with their three taps lies contiguous in the frame kernel, so each block
// streams its kernel rows as they lie (16-byte loads where C and the
// pointer allow, else element loads) and reorders them into [column][k] in
// shared memory; its A is the frame's y rows -1 .. 64, each element stored
// at its three taps. Two shared-memory stages, the next chunk loaded into
// registers over the current chunk's products (bf16 m16n8k16, f32
// split-TF32 m16n8k8, both summed from zero each k-step and added in f32,
// as gemm_mma.cuh's FRESH products, which the conv runs too: a long sum
// kept on the tensor cores truncates). Epilogue: the bias, the gate, the
// round and x = round(round(x + ad) + gate). Bound: the frame kernels'
// bytes at hop 64, the products at hop 256 in f32 (PERF.md).
constexpr int kRouteWide = 3;

namespace wide {

constexpr int kBM = 64, kGC = 128, kBN = 2 * kGC, kThreads = 256;

// CK input channels a chunk (3 CK k values: three k16 steps in bf16, three
// k8 steps in f32); LD the [row][k] stride in shared memory, padded so that
// a fragment read's eight rows by four k fall in distinct banks
template <typename T> struct Geo;
template <> struct Geo<__nv_bfloat16> {
  static constexpr int CK = 16, LD = 56;
};
template <> struct Geo<float> {
  static constexpr int CK = 8, LD = 28;
};

// ops/fastdiff_lvc.py WIDE_SMEM: two stages of the A and the B tile
template <typename T> constexpr int smem_bytes() {
  return 2 * (kBM + kBN) * Geo<T>::LD * static_cast<int>(sizeof(T));
}

__device__ __forceinline__ uint4 zero4() { return make_uint4(0, 0, 0, 0); }

// a chunk's frame-kernel rows: for each of CK input channels, the block's
// 128 gate columns of either half with their taps, 384 contiguous values a
// run; elements past C (columns or channels) read 0
template <typename T, bool VEC_OK> struct KernLoad {
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T)), RV = kGC * 3 / VEC;
  static constexpr int NV = Geo<T>::CK * 2 * RV / kThreads;
  uint4 v[NV];

  static __device__ __forceinline__ void at(int n, int& cc, int& h, int& e0) {
    const int i = threadIdx.x + n * kThreads;
    cc = i / (2 * RV);
    h = (i / RV) & 1;
    e0 = (i % RV) * VEC;
  }
  // kf: the frame's kernel of this layer, (C, 2C, 3); c0 the chunk's first
  // channel; g0 the block's first gate column
  __device__ __forceinline__ void load(const T* kf, int C, int c0, int g0) {
    const int lim = 3 * (C - g0);  // valid values of a run
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      int cc, h, e0;
      at(n, cc, h, e0);
      const int c = c0 + cc;
      const T* p = kf + static_cast<size_t>(c) * 6 * C + (h * C + g0) * 3 + e0;
      if (VEC_OK) {  // lim and e0 are multiples of VEC: a vector is wholly in or out
        v[n] = (c < C && e0 < lim) ? *reinterpret_cast<const uint4*>(p) : zero4();
      } else {
        T* e = reinterpret_cast<T*>(&v[n]);
#pragma unroll
        for (int q = 0; q < VEC; ++q)
          e[q] = (c < C && e0 + q < lim) ? p[q] : lfs2::from_f<T>(0.0f);
      }
    }
  }
  // into Bs[row][k]: gate column g of half h is row (g / 16) 32 + 16 h + g %
  // 16 (warp g / 16 holds both halves), k = cc * 3 + tap
  __device__ __forceinline__ void store(T* Bs) const {
    constexpr int LD = Geo<T>::LD;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      int cc, h, e0;
      at(n, cc, h, e0);
      const T* e = reinterpret_cast<const T*>(&v[n]);
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const int el = e0 + q, g = el / 3, tap = el - 3 * g;
        Bs[((g >> 4) * 32 + h * 16 + (g & 15)) * LD + cc * 3 + tap] = e[q];
      }
    }
  }
};

// a chunk's signal rows: y at window rows 0 .. kBM + 1 (signal position s0
// + w, zero outside [0, L)) by CK channels, each value stored at row w - tap
// for its three taps
template <typename T> struct RowLoad {
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T)), PER = Geo<T>::CK / VEC;
  static constexpr int N = (kBM + 2) * PER;
  static_assert(N <= kThreads, "one window vector a thread");
  uint4 v;

  __device__ __forceinline__ void load(const T* yb, int L, int Cp, int s0, int c0) {
    const int i = threadIdx.x, s = s0 + i / PER;
    const T* p = yb + static_cast<size_t>(s) * Cp + c0 + (i % PER) * VEC;
    v = (i < N && s >= 0 && s < L) ? *reinterpret_cast<const uint4*>(p) : zero4();
  }
  __device__ __forceinline__ void store(T* As) const {
    constexpr int LD = Geo<T>::LD;
    const int i = threadIdx.x;
    if (i >= N) return;
    const int w = i / PER, cb = (i % PER) * VEC;
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int q = 0; q < VEC; ++q)
#pragma unroll
      for (int tap = 0; tap < 3; ++tap) {
        const int t = w - tap;
        if (t >= 0 && t < kBM) As[t * LD + (cb + q) * 3 + tap] = e[q];
      }
  }
};

// one chunk's products into the warp's 64 x 32 accumulators (m-tile i, n-tile j)
__device__ __forceinline__ void chunk(const __nv_bfloat16* As, const __nv_bfloat16* Bs,
                                      float (&acc)[4][4][4], int wn, int lane) {
  constexpr int LD = Geo<__nv_bfloat16>::LD, KC = 3 * Geo<__nv_bfloat16>::CK;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < KC; ks += 16) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat16* p = As + (i * 16 + g) * LD + ks + 2 * t;
      a[i][0] = lfs2::gemm::ld32(p);
      a[i][1] = lfs2::gemm::ld32(p + 8 * LD);
      a[i][2] = lfs2::gemm::ld32(p + 8);
      a[i][3] = lfs2::gemm::ld32(p + 8 * LD + 8);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat16* p = Bs + (wn * 32 + j * 8 + g) * LD + ks + 2 * t;
      b[j][0] = lfs2::gemm::ld32(p);
      b[j][1] = lfs2::gemm::ld32(p + 8);
    }
    // each k-step summed from zero, added in f32 (gemm_mma.cuh FRESH)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        lfs2::mma_bf16(part, a[i], b[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[e];
      }
  }
}

__device__ __forceinline__ void chunk(const float* As, const float* Bs, float (&acc)[4][4][4],
                                      int wn, int lane) {
  constexpr int LD = Geo<float>::LD, KC = 3 * Geo<float>::CK;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int ks = 0; ks < KC; ks += 8) {
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* p = Bs + (wn * 32 + j * 8 + g) * LD + ks + t;
      lfs2::split(p[0], bh[j][0], bl[j][0]);
      lfs2::split(p[4], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* p = As + (i * 16 + g) * LD + ks + t;
      uint32_t ah[4], al[4];
      lfs2::split_a(p[0], p[8 * LD], p[4], p[8 * LD + 4], ah, al);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        lfs2::mma3(part, ah, al, bh[j], bl[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[e];
      }
    }
  }
}

// grid (mtiles * ceil(C / kGC), nL, B): blockIdx.x % mtiles the frame's row
// tile (so the blocks that share a frame's kernel run side by side),
// blockIdx.x / mtiles the gate-column tile
template <typename T, bool FAST, bool VEC_OK>
__global__ void __launch_bounds__(kThreads)
lvc_wide_kernel(const T* x_in, const T* __restrict__ ad, const T* __restrict__ kern,
                const float* __restrict__ bias, const T* __restrict__ y, T* x_out, int L, int C,
                int Cp, int hop, int layer, int layers, int mtiles) {
  // x_in is x_out past layer 0 (each value read, then written, by one thread)
  constexpr int LD = Geo<T>::LD, CK = Geo<T>::CK;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  T* As = reinterpret_cast<T*>(wide_smem);  // stage s: As + s kBM LD, Bs + s kBN LD
  T* Bs = As + 2 * kBM * LD;
  const int m0 = (blockIdx.x % mtiles) * kBM, g0 = (blockIdx.x / mtiles) * kGC;
  const int f = blockIdx.y, b = blockIdx.z, nL = gridDim.y;
  const int wn = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t fr = (static_cast<size_t>(b) * nL + f) * layers + layer;
  const T* kf = kern + fr * 6 * static_cast<size_t>(C) * C;
  const float* bf = bias + fr * 2 * C;
  const T* yb = y + static_cast<size_t>(b) * L * Cp;
  const int s0 = f * hop + m0 - 1;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  KernLoad<T, VEC_OK> kl;
  RowLoad<T> rl;
  kl.load(kf, C, 0, g0);
  rl.load(yb, L, Cp, s0, 0);
  kl.store(Bs);
  rl.store(As);
  __syncthreads();
  const int chunks = (C + CK - 1) / CK;
  for (int ch = 0, s = 0; ch < chunks; ++ch, s ^= 1) {
    const bool more = ch + 1 < chunks;
    if (more) {
      kl.load(kf, C, (ch + 1) * CK, g0);
      rl.load(yb, L, Cp, s0, (ch + 1) * CK);
    }
    chunk(As + s * kBM * LD, Bs + s * kBN * LD, acc, wn, lane);
    if (more) {
      kl.store(Bs + (s ^ 1) * kBN * LD);
      rl.store(As + (s ^ 1) * kBM * LD);
    }
    __syncthreads();
  }
  // n-tiles 0, 1 hold the sigmoid half of gate columns g0 + 16 wn + 8 j + 2
  // t + e, n-tiles 2, 3 the tanh half of the same columns
  const int g = lane >> 2, t = lane & 3;
  const size_t row0 = static_cast<size_t>(b) * L + static_cast<size_t>(f) * hop;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = m0 + i * 16 + g + 8 * h, gc = g0 + wn * 16 + j * 8 + 2 * t + e;
          const size_t o = (row0 + r) * Cp + gc;
          if (r < hop && gc < C) {
            const float gv = lfs2::round_to<T>(
                gate<FAST>(acc[i][j][2 * h + e] + bf[gc], acc[i][j + 2][2 * h + e] + bf[C + gc]));
            const float xv = lfs2::round_to<T>(lfs2::to_f(x_in[o]) + lfs2::to_f(ad[o]));
            x_out[o] = lfs2::from_f<T>(xv + gv);
          } else if (r < hop && gc < Cp) {  // the padded channels stay 0 (the next conv reads them)
            x_out[o] = lfs2::from_f<T>(0.0f);
          }
        }
}

// A of the conv: row m = b L + l, k index kk = j Cp + cin -> leaky(round(x +
// ad)) at l + (j - 1) d (zero outside [0, L)); 16 bytes of consecutive input
// channels a call
template <typename T> struct ConvRows {
  const T* x;
  const T* ad;
  int L, Cp, d;
  __device__ __forceinline__ uint4 vec(int m, int kk) const {
    const int j = kk / Cp, ci = kk - j * Cp;
    const int b = m / L, l = m - b * L, src = l + (j - 1) * d;
    if (src < 0 || src >= L) return make_uint4(0, 0, 0, 0);
    const size_t o = (static_cast<size_t>(b) * L + src) * Cp + ci;
    uint4 v = *reinterpret_cast<const uint4*>(x + o);
    const uint4 a = *reinterpret_cast<const uint4*>(ad + o);
    T* e = reinterpret_cast<T*>(&v);
    const T* ea = reinterpret_cast<const T*>(&a);
#pragma unroll
    for (int q = 0; q < lfs2::gemm::vec_elems<T>(); ++q) {
      const float s = lfs2::round_to<T>(lfs2::to_f(e[q]) + lfs2::to_f(ea[q]));
      e[q] = lfs2::from_f<T>(fmaxf(s, s * 0.2f));
    }
    return v;
  }
};

// the conv's epilogue: y = round(leaky(acc + conv_b)), columns below Cp
template <typename T> struct ConvEp {
  T* y;
  const float* cb;
  int Cp;
  __device__ void operator()(const float (&acc)[4][4][4], int mw, int nw, int lane, int M) const {
    lfs2::gemm::for_each_pair(acc, mw, nw, lane, M, [&](int m, int n, int, float v0, float v1) {
      if (n >= Cp) return;
      const float a = v0 + cb[n], c = v1 + cb[n + 1];
      T* p = y + static_cast<size_t>(m) * Cp + n;
      p[0] = lfs2::from_f<T>(fmaxf(a, a * 0.2f));
      p[1] = lfs2::from_f<T>(fmaxf(c, c * 0.2f));
    });
  }
};

template <typename T>
cudaError_t conv(const T* x, const T* ad, const T* w, const float* cb, T* y, int M, int L, int Cp,
                 int d, cudaStream_t s) {
  namespace gm = lfs2::gemm;
  const int K = 3 * Cp, kper = (K + gm::kBK - 1) / gm::kBK * gm::kBK;
  const dim3 grid((Cp + gm::kBN - 1) / gm::kBN, (M + gm::kBM - 1) / gm::kBM, 1);
  constexpr int smem = gm::smem_bytes<T>();
  auto kernel = gm::gemm_kernel<T, true, false, ConvRows<T>, gm::Mat<T>, ConvEp<T>, true>;
  if (smem > 48 * 1024) {
    const cudaError_t e = lfs2::allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
  }
  // B(n, kk) = w[kk][n]: the taps (3, Cp, Cp) as they lie, n contiguous
  kernel<<<grid, gm::kThreads, smem, s>>>(ConvRows<T>{x, ad, L, Cp, d}, gm::Mat<T>{w, 1, Cp},
                                          ConvEp<T>{y, cb, Cp}, M, Cp, K, kper);
  return cudaGetLastError();
}

template <typename T, bool FAST, bool VEC_OK>
cudaError_t chain(const T* x, const T* ad, const T* kern, const float* bias, const T* conv_w,
                  const float* conv_b, T* out, T* y, int B, int L, int C, int Cp, int hop,
                  int layers, cudaStream_t s) {
  constexpr int smem = smem_bytes<T>();
  auto kernel = lvc_wide_kernel<T, FAST, VEC_OK>;
  cudaError_t e = lfs2::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int mtiles = (hop + kBM - 1) / kBM;
  const dim3 grid(mtiles * ((C + kGC - 1) / kGC), L / hop, B);
  for (int i = 0, d = 1; i < layers; ++i, d *= 3) {
    const T* xin = i == 0 ? x : out;
    e = conv<T>(xin, ad, conv_w + static_cast<size_t>(i) * 3 * Cp * Cp, conv_b + i * Cp, y, B * L,
                L, Cp, d, s);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, smem, s>>>(xin, ad, kern, bias, y, out, L, C, Cp, hop, i, layers,
                                        mtiles);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return record_launch(kRouteWide, kBM, dim3(grid.x * grid.y, grid.z), smem, 0, 0, Cp);
}

template <typename T>
cudaError_t run(const void* x, const void* ad, const void* kern, const float* bias,
                const void* conv_w, const float* conv_b, void* out, void* y, int B, int L, int C,
                int hop, int layers, int fast, cudaStream_t s) {
  const int Cp = (C + 15) / 16 * 16;
  if (L / hop > 65535 || B > 65535) return cudaErrorInvalidValue;
  // 16-byte kernel loads need every run of a channel row on 16 bytes
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const bool vec_ok = C % VEC == 0 && reinterpret_cast<uintptr_t>(kern) % 16 == 0;
  const T* xa = static_cast<const T*>(x);
  const T* ada = static_cast<const T*>(ad);
  const T* ka = static_cast<const T*>(kern);
  const T* wa = static_cast<const T*>(conv_w);
  T* o = static_cast<T*>(out);
  T* ya = static_cast<T*>(y);
#define LFS2_WIDE(F, V) \
  chain<T, F, V>(xa, ada, ka, bias, wa, conv_b, o, ya, B, L, C, Cp, hop, layers, s)
  if (fast) return vec_ok ? LFS2_WIDE(true, true) : LFS2_WIDE(true, false);
  return vec_ok ? LFS2_WIDE(false, true) : LFS2_WIDE(false, false);
#undef LFS2_WIDE
}

}  // namespace wide

}  // namespace

LFS2_DEFINE_ERROR_STRING

// x, ad, out (B, L, C); kern (B, L / hop, layers, C, 2C, 3) and conv_w
// (layers, 3, C, C) in the working dtype; bias (B, L / hop, layers, 2C) and
// conv_b (layers, C) f32; C one of 16, 32, 64, 128. route 1 (tensor cores,
// weights staged: bf16 at C <= 64, f32 at C <= 32) and route 2 (tensor
// cores, weights read from device memory: the other widths): hop and tile
// multiples of 8, nt in {1, 2, 4} (bf16) or {1, 2} (f32) n8 row tiles an
// LVC chunk, 8 * nt dividing hop; route 1 stages round_frames >= 1 frames a
// round (at most 2 in f32 with nt > 1), route 2 none (round_frames 0).
// route 0 (CUDA cores): tile a multiple of 4 (round_frames and nt unused).
LFS2_EXPORT int lfs2_lvc_stack(const void* x, const void* ad, const void* kern, const float* bias,
                               const void* conv_w, const float* conv_b, void* out, int B, int L,
                               int C, int hop, int layers, int tile, int fast, int dtype,
                               int route, int round_frames, int nt, void* stream) {
  if (B < 1 || L < 1 || hop < 1 || L % hop != 0 || layers < 1 || layers > kMaxLayers ||
      (dtype != lfs2::kBF16 && dtype != lfs2::kF32))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, ad, kern, bias, conv_w, conv_b, out, B, L, hop, layers, tile, fast, route,
               round_frames, nt};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == lfs2::kBF16 ? run_width<__nv_bfloat16>(C, a, s)
                                               : run_width<float>(C, a, s));
}

// The wide route (route 3, C > 128): x, ad, out (B, L, Cp) with Cp = C
// rounded up to 16, the channels past C zero; kern (B, L / hop, layers, C,
// 2C, 3) and bias (B, L / hop, layers, 2C) at the real C; conv_w (layers, 3,
// Cp, Cp) and conv_b (layers, Cp) zero-padded; y (B, L, Cp) scratch of the
// working dtype. x, ad, out, conv_w and y on 16 bytes.
LFS2_EXPORT int lfs2_lvc_stack_wide(const void* x, const void* ad, const void* kern,
                                    const float* bias, const void* conv_w, const float* conv_b,
                                    void* out, void* y, int B, int L, int C, int hop, int layers,
                                    int fast, int dtype, void* stream) {
  if (B < 1 || L < 1 || hop < 1 || L % hop != 0 || layers < 1 || layers > kMaxLayers || C < 1 ||
      (dtype != lfs2::kBF16 && dtype != lfs2::kF32))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == lfs2::kBF16
          ? wide::run<__nv_bfloat16>(x, ad, kern, bias, conv_w, conv_b, out, y, B, L, C, hop,
                                     layers, fast, s)
          : wide::run<float>(x, ad, kern, bias, conv_w, conv_b, out, y, B, L, C, hop, layers,
                             fast, s));
}

#ifdef LFS2_LVC_PHASE_CLOCKS
// copies g_phase (kMmaWarpsMax x 8 cycle counts) into out
LFS2_EXPORT int lfs2_lvc_stack_phase_clocks(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase)));
}
#endif

// copies into out[0..7] the route (0 CUDA cores, 1 tensor cores staged, 2
// tensor cores direct, 3 wide), tile, grid x and y, shared-memory bytes,
// frames staged a round, n8 tiles an LVC chunk and channels of the latest
// accepted launch (the wide route: its last LVC launch, as grid x its
// blocks of one item, grid y the items); zeros before the first
LFS2_EXPORT int lfs2_lvc_stack_last_launch(int* out) {
  for (int i = 0; i < 8; ++i) out[i] = g_last_launch[i];
  return 0;
}

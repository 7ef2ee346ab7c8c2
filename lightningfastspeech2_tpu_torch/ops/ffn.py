"""The FFN half of a conformer FFT block: LN1 -> depthwise conv ->
pointwise up -> ReLU -> (grouped conv folded into) pointwise down ->
residual on the LN1 output -> LN2.

Counterpart of ``lightningfastspeech2_tpu/ops/pallas_ffn.py``:
``fused_ffn_ln`` (kernel ``_ffn_kernel``) as ``ffn_ln``, and
``fused_ffn_ln_train`` (kernels ``_ffn_train_kernel`` and
``_ffn_train_bwd_kernel``, joined by a custom VJP) as ``ffn_ln_train``.
``ffn_ln`` launches the CUDA kernel in ``csrc/ffn_ln.cu`` for a CUDA tensor
and runs ``ffn_ln_plain`` for a CPU tensor; ``ffn_ln_train`` launches the
same source's training forward and the backward's three launches (the
chain in ``csrc/ffn_ln.cu``, the dup and dt1 passes in
``csrc/ffn_ln_train_bwd.cu``) through an autograd Function, or runs
``ffn_ln_train_plain`` on the CPU. Both dtypes run the products on the
tensor cores: bf16 on wgmma, f32 as split-TF32 ``mma.sync`` (three TF32
products a product, f32's digits). Training at every C from 384, and serving
at every C from 768, that is a multiple of 128 (``on_chain``), run
``csrc/ffn_wide.cu`` instead: the half as a
chain of launches (LN1, depthwise, the two products on ``mma.sync``, LN2;
the backward's LN2 backward, four more products and the depthwise and LN1
backwards), cut where a row's C-wide accumulator no longer fits a block. The rounding points follow the TPU
kernel: LN1 output, depthwise output and ReLU output are rounded to the
working dtype; the depthwise taps, both products and both LayerNorms
accumulate in f32. ``ffn_ln_train_bwd_plain`` is the backward's stages in
plain PyTorch, with their rounding points (none in f32).

``ffn_plan`` sizes every launch of both sources (rows a block owns, F
chunk, weight buffers, shared memory, grid): the table of
``csrc/ffn_sm90.cuh``, which the CUDA sources check with static_asserts and
``last_launches`` reads back from the libraries.

Kernel weight layouts are prepared once, when weights load
(``prepare_ffn_weights``), or once per training call (the autograd
Function keeps the forward's for the backward), not per launch: the
grouped k=1 conv and the down-projection compose into one (F, C) matrix
(``fold_grouped_into_down``); the bf16 kernels read W1 and W2f as one
pre-swizzled image (``_weight_image``), the f32 kernels as TF32 hi / lo
halves in ``mma.sync`` fragment order (``_f32_image``); each is one
gather through an index cached per shape.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as nnf

from lightningfastspeech2_tpu_torch.kernels import build
from lightningfastspeech2_tpu_torch.kernels.launch import kernel_stream, refuse_grad
from lightningfastspeech2_tpu_torch.ops import gemm
from lightningfastspeech2_tpu_torch.ops.depthwise import depthwise_conv1d
from lightningfastspeech2_tpu_torch.ops.hifigan_resblock import tf32
from lightningfastspeech2_tpu_torch.ops.layer_norm import layer_norm_fn

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
_c_fn = None
_c_wide = None
_c_train = None
_c_chain = None
_c_bwd = None
_c_chain_fwd = None
_c_chain_bwd = None


def _lib_fn(name: str, symbol: str, argtypes):
    """A launcher of ``csrc/<name>.cu``'s library, its argument types set."""
    lib = build.load(name)
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib, fn


@dataclass
class FFNWeights:
    """Prepared weights of one FFN half, on the device it runs on."""

    wd: torch.Tensor    # (k, C) f32 depthwise taps
    w1: torch.Tensor    # (C, F) working dtype, pointwise up
    b1: torch.Tensor    # (F,) f32
    w2f: torch.Tensor   # (F, C) working dtype, grouped conv folded into down
    lnp: torch.Tensor   # (6, C) f32: g1, be1, g2, be2, bd, b2f
    eps: float = 1e-5
    img: Optional[torch.Tensor] = None  # W1 and W2f as the kernel reads them (built at first use)

    @property
    def kernel_size(self) -> int:
        return self.wd.shape[0]


def fold_grouped_into_down(wg, bg, w2, b2, groups: int):
    """Compose the k=1 grouped conv (F -> F, ``groups`` groups; torch
    weight (G*co, ci, 1)) with the pointwise down-projection (F -> C;
    torch weight (C, F, 1)) into one (F, C) matrix and a (C,) bias. Exact
    in real arithmetic: both are linear with nothing between them. f32."""
    G = groups
    Fo, ci, _ = wg.shape
    co = Fo // G
    C = w2.shape[0]
    wg_r = wg[:, :, 0].float().reshape(G, co, ci)
    w2m = w2[:, :, 0].float()                       # (C, F)
    w2f = torch.einsum("goi,cgo->gic", wg_r, w2m.reshape(C, G, co))
    b2f = b2.float() + w2m @ bg.float()
    return w2f.reshape(G * ci, C), b2f


def prepare_ffn_weights(conv1_depth, conv1_point, conv2_group, conv2_point,
                        norm1, norm2, dtype: torch.dtype,
                        eps: float = 1e-5) -> FFNWeights:
    """Kernel layouts from the block's torch modules (Conv1d / LayerNorm
    parameter holders), in ``dtype`` for the two products."""
    with torch.no_grad():
        C = conv1_depth.weight.shape[0]
        w2f, b2f = fold_grouped_into_down(
            conv2_group.weight, conv2_group.bias, conv2_point.weight,
            conv2_point.bias, groups=C)
        lnp = torch.stack([
            norm1.weight.float(), norm1.bias.float(),
            norm2.weight.float(), norm2.bias.float(),
            conv1_depth.bias.float(), b2f,
        ])
        return FFNWeights(
            wd=conv1_depth.weight[:, 0, :].t().float().contiguous(),
            w1=conv1_point.weight[:, :, 0].t().to(dtype).contiguous(),
            b1=conv1_point.bias.detach().float().contiguous(),
            w2f=w2f.to(dtype).contiguous(),
            lnp=lnp.contiguous(),
            eps=eps,
        )


def ffn_ln_plain(z: torch.Tensor, w: FFNWeights) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same rounding points."""
    dt = z.dtype
    g1, be1, g2, be2, bd, b2f = w.lnp
    t1 = layer_norm_fn(z, g1, be1, dt, w.eps).float()
    # depthwise taps in f32 (weight (C, 1, k) for F.conv1d)
    h0 = depthwise_conv1d(t1, w.wd.t().unsqueeze(1), bd).to(dt)
    up = torch.relu(h0.float() @ w.w1.float() + w.b1).to(dt)
    ff = up.float() @ w.w2f.float() + b2f
    return layer_norm_fn(t1 + ff, g2, be2, dt, w.eps)


def _fn():
    global _c_fn
    if _c_fn is None:
        _c_fn = _lib_fn("ffn_ln", "lfs2_ffn_ln", [_P] * 6 + [_I] * 6 + [_F, _I, _P])
    return _c_fn


def _wide_fn():
    global _c_wide
    if _c_wide is None:
        _c_wide = _lib_fn("ffn_ln", "lfs2_ffn_ln_wide", [_P] * 7 + [_I] * 7 + [_F, _I, _P])
    return _c_wide


def ffn_ln(z: torch.Tensor, w: FFNWeights) -> torch.Tensor:
    """LN2(LN1(z) + ConvFFN(LN1(z))) for z (B, T, C) in f32 or bf16.

    CPU tensors take ``ffn_ln_plain``; CUDA tensors launch the kernel,
    which takes the widths ``serve_ok`` admits (C in ``NARROW_C`` or any
    multiple of 128 from 384: every width the JAX serving gate fuses) and F
    a multiple of 128, and raises on anything else. The kernel's result is invisible to autograd,
    so on the card it raises when grad mode is on and an input needs a
    gradient."""
    if z.device.type == "cpu":
        return ffn_ln_plain(z, w)
    refuse_grad("ffn_ln", "ffn_ln_train", z, w.wd, w.w1, w.b1, w.w2f, w.lnp)
    stream = kernel_stream(z, w.wd, w.w1, w.b1, w.w2f, w.lnp, w.img)
    B, T, C = z.shape
    F = w.w1.shape[1]
    if z.dtype not in build.DTYPE_CODES or w.w1.dtype != z.dtype or w.w2f.dtype != z.dtype:
        raise ValueError(f"ffn_ln takes f32 or bf16 z with weights of the same "
                         f"dtype, got {z.dtype}, {w.w1.dtype}, {w.w2f.dtype}")
    if not serve_ok(C) or F % 128 != 0:
        raise ValueError(f"ffn_ln kernel takes C in {NARROW_C} or a multiple of 128 from "
                         f"{CHAIN_MIN_C}, and F % 128 == 0, got C={C}, F={F}")
    plans = ffn_plan(C, F, w.kernel_size, B, T, z.dtype, "serve")
    plan = plans[0]
    if not all(_fits(p, w.kernel_size) for p in plans):
        raise ValueError(f"ffn_ln kernel: k={w.kernel_size} at C={C} needs {plan.smem_bytes} "
                         f"bytes of shared memory (at most {SMEM_LIMIT}), a t1 window of "
                         f"{plan.rows + w.kernel_size - 1} rows (at most {_F32_WINDOW} in f32) "
                         f"or, past C = 640, k <= {_CHAIN_MAX_K}")
    if on_chain(C, "serve"):
        if w.img is None:
            w.img = _chain_image(w.w1, w.w2f, z.dtype)
        out = _chain_fwd(z, w.wd, w.b1, w.lnp, w.img, F, None, w.eps, 0, 1.0, stream)
        ffn_ln.launches += 1
        ffn_ln.by_width[C] = ffn_ln.by_width.get(C, 0) + 1
        return out
    wide = C in WIDE_C
    if w.img is None:
        if wide:
            w.img = (_wide_f32_image if z.dtype == torch.float32 else _wide_image)(w.w1, w.w2f)
        else:
            w.img = (_f32_image(w.w1, w.w2f, "fwd") if z.dtype == torch.float32
                     else _weight_image(w.w1, w.w2f))
    out = torch.empty_like(z)
    code = build.DTYPE_CODES[z.dtype]
    if wide:
        splits = plan.grid[2]
        part = torch.empty(splits, B, T, C, dtype=torch.float32, device=z.device)
        lib, fn = _wide_fn()
        rc = fn(z.data_ptr(), out.data_ptr(), part.data_ptr(), w.wd.data_ptr(), w.b1.data_ptr(),
                w.lnp.data_ptr(), w.img.data_ptr(), B, T, C, F, w.kernel_size, splits,
                plan.cluster, w.eps, code, stream)
    else:
        lib, fn = _fn()
        rc = fn(z.data_ptr(), out.data_ptr(), w.wd.data_ptr(), w.b1.data_ptr(), w.lnp.data_ptr(),
                w.img.data_ptr(), B, T, C, F, w.kernel_size, plan.rows, w.eps, code, stream)
    build.check(lib, rc, "ffn_ln")
    ffn_ln.launches += 1
    ffn_ln.by_width[C] = ffn_ln.by_width.get(C, 0) + 1
    return out


ffn_ln.launches = 0
ffn_ln.by_width = {}  # launches by channel count C, set to {} with the count



# ---------------------------------------------------------------------------
# the launches' geometry: csrc/ffn_sm90.cuh's tables (bf16 wgmma, f32 split TF32)
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232448  # bytes of dynamic shared memory a block may use (H100)
NARROW_C = (32, 64, 128, 256)  # csrc/ffn_ln.cu's fused kernels: serving and training
WIDE_C = (384, 512, 640)       # widths ffn_wide_kernel serves
CHAIN_MIN_C = 384    # csrc/ffn_wide.cu's chain: multiples of 128 from here
LANE_MAX_C = 768     # its row kernels hold a row in registers up to here, past it read it again
SM_COUNT = 132       # streaming multiprocessors of an H100 SXM
_ROWS = 128          # kRows: rows of one item a wgmma block owns (two warpgroups of 64)
_FC = 64             # kFC: F columns per weight chunk
_THREADS = 256       # kThreads: two warpgroups (bf16), eight warps (f32)
_DT1_ROWS = 64       # kDt1Rows: rows a depthwise/LN1-backward block owns
_DT1_THREADS = 256
_MAX_K = {torch.bfloat16: 63, torch.float32: 50}  # kMaxK, kMaxKF32 (the f32 dt1 tile)
_F32_ROWS = (64, 32)  # rows a split-TF32 block may own
_F32_FC, _DUP_FC = 32, 16  # kF32FC, kDupFC: F columns per forward / dup chunk
_F32_WINDOW = 2 * _F32_FC * 8 // 4  # rows of t1 the two f32 piece buffers hold
_STAGE_LD = _DUP_FC + 4  # kStageLd
_BAR_BYTES = 64
# csrc/ffn_wide.cu: rows a forward row-kernel block owns (one a warp), rows
# a backward row-kernel block owns, the depthwise tiles (rows, channels),
# and the depthwise kernel sizes the chain takes
_CHAIN_WARP_ROWS, _CHAIN_RED_ROWS = 8, 128
_CHAIN_DW_ROWS, _CHAIN_DW_CH = 64, 64
_CHAIN_MAX_K = 63


def on_chain(C: int, mode: str) -> bool:
    """Whether a call at width C runs ``csrc/ffn_wide.cu``'s chain:
    training ("train", "bwd") from 384 on, serving ("serve") from 768 on
    (below it ``ffn_wide_kernel`` serves ``WIDE_C``)."""
    if C < CHAIN_MIN_C or C % 128:
        return False
    return C not in WIDE_C or mode != "serve"


def serve_ok(C: int) -> bool:
    """Whether ``ffn_ln`` serves width C on the card: ``NARROW_C``,
    ``WIDE_C`` or the chain, so every multiple of 128 (every width the JAX
    serving gate fuses) and 32, 64."""
    return C in NARROW_C or C in WIDE_C or on_chain(C, "serve")


def train_ok(C: int) -> bool:
    """Whether the training kernels take width C: ``NARROW_C`` or the
    chain, so every multiple of 128 and 32, 64."""
    return C in NARROW_C or on_chain(C, "train")


@dataclass(frozen=True)
class FFNLaunch:
    """One kernel launch: the kernel, the rows of one batch item a block
    owns, the F columns per weight chunk, the weight-chunk buffers in flight
    (a W1 and a W2f buffer each refilled as soon as its chunk is released,
    or the wide kernel's ring slots; 0 where the kernel stages no weights),
    shared memory a block, grid, threads a block and cluster size."""

    kernel: str
    rows: int
    fchunk: int
    stages: int
    smem_bytes: int
    grid: Tuple[int, int, int]
    threads: int
    cluster: int = 1  # blocks along grid x that share each weight tile


def _cp(C: int) -> int:
    """Channels as the bf16 kernels' tiles hold them (C = 32 runs as 64)."""
    return max(C, 64)


def _fwd_smem(C: int, k: int) -> int:
    cp, w = _cp(C), _ROWS + k - 1
    return 1024 + 2 * cp * 128 + _ROWS * cp * 2 + max(w * cp * 2, _ROWS * _FC * 2) + w * 8 + 64


def _dup_smem(C: int) -> int:
    cp = _cp(C)
    return 1024 + 2 * cp * 128 + 2 * _ROWS * cp * 2 + 2 * _ROWS * _FC * 2 + 64


def _dt1_smem(C: int, k: int, elem: int) -> int:
    return (_DT1_ROWS + k - 1) * C * (4 + elem)


def _piece_bytes(C: int, fc: int) -> int:
    """A split K x N product operand with K N = C fc: hi and lo, 8 bytes."""
    return C * fc * 8


def _f32_fwd_smem(R: int, C: int, k: int) -> int:
    return (2 * _piece_bytes(C, _F32_FC) + R * C * 4 + 2 * R * _F32_FC * 8 + _BAR_BYTES
            + (R + k - 1) * 8)


def _f32_dup_smem(R: int, C: int) -> int:
    return (2 * _piece_bytes(C, _DUP_FC) + 2 * R * C * 4 + R * _DUP_FC * 8
            + 4 * R * _STAGE_LD * 4 + R * _DUP_FC * 4 + _BAR_BYTES)


_WIDE_FC = 32           # kWideFC: F columns a chunk
_WIDE_F32_SLOTS = 6     # kWideF32Slots
_WIDE_PIECES = 8        # kWidePieces: z pieces of 8 values a thread holds in the prologue
# CTAs an H100 holds at once at about 210 KB of shared memory each, by
# cluster size (clusters of 4: 28, resblock.cu's measured count; the wide
# launch records cudaOccupancyMaxActiveClusters beside each launch)
_WIDE_AT_ONCE = {1: SM_COUNT, 2: SM_COUNT, 4: 112}


def _wide_geometry(C: int, dtype: torch.dtype) -> Tuple[int, int, int, int]:
    """``WideGeo``: rows a block owns, bytes a weight tile, weight buffers
    (f32: ring slots; bf16: W1 buffers A and B and each warpgroup's W2f
    boxes), threads a block (eight warps; f32 also the producer warp)."""
    if dtype == torch.float32:
        return 32, 16384, _WIDE_F32_SLOTS, 288
    return 64, 4096, 4, 256


def _wide_smem(C: int, k: int, dtype: torch.dtype) -> int:
    """``WideGeo::smem``: 1 KB of alignment, the weight buffers (f32: the
    ring; bf16: W1 buffer A and the W2f boxes), h0, two up stagings, the
    region that is the t1 window of a 64-channel box (f32) and then, in
    f32, the up product's K-quarter partials or, in bf16, W1 buffer B, each
    window row's LN1 statistics and three mbarriers a buffer."""
    R, tile, ns, _ = _wide_geometry(C, dtype)
    w = R + k - 1
    if dtype == torch.float32:
        buffers, h0, stage, region = ns * tile, R * C * 4, R * _WIDE_FC * 8, 4 * R * _WIDE_FC * 4
    else:
        buffers, h0, stage, region = 2 * (C // 64) * tile, R * C * 2, R * 128, (C // 64) * tile
    return 1024 + buffers + h0 + 2 * stage + max(w * 64 * 4, region) + w * 8 + 3 * ns * 8


def _wide_ln2_warps(splits: int) -> int:
    """``wide_ln2_warps``: the warps an LN2 row takes (up to 8, each adding
    every WR-th split), so that a block of 8 warps owns 8 / WR rows."""
    return 8 if splits >= 8 else 4 if splits >= 4 else 2 if splits >= 2 else 1


def _wide_split(B: int, T: int, R: int, nch: int) -> Tuple[int, int, int]:
    """(grid x, cluster, splits) of a wide launch. A cluster of m row tiles
    of one item shares each weight copy: up to 4 while B tiles stay below a
    quarter of the card (the image read about once), else 2 (clusters of 4
    would not all fit at once), halved while padding grid x to a multiple
    of m would add more than a quarter of the tiles. F is split so that the
    blocks come near the CTAs the card holds at once, every split with the
    same count of chunks but the last."""
    tiles = -(-T // R)
    m = 1
    while m < min(tiles, 2 if B * tiles >= SM_COUNT // 4 else 4):
        m *= 2
    while m > 2 and -(-tiles // m) * m - tiles > tiles // 4:
        m //= 2
    x = -(-tiles // m) * m
    splits = max(1, min(nch, _WIDE_AT_ONCE[m] // (B * x)))
    per = -(-nch // splits)
    return x, m, -(-nch // per)


def _chain_plan(C: int, F: int, k: int, B: int, T: int, dtype: torch.dtype,
                mode: str) -> Tuple[FFNLaunch, ...]:
    """The launches of ``csrc/ffn_wide.cu``, in order: LN1 (8 rows a block,
    one a warp; past ``LANE_MAX_C`` the kernel that reads its row twice), the
    depthwise conv (64 rows of one item by 64 channels a
    block, the t1 window in shared memory), the up and down products
    (``ops/gemm.py``: 128 x 128 output tiles); serving and the training
    forward then LN2; the backward instead the LN2 backward (128 rows a
    block, their column sums met in shared memory), the dup and dacc
    products, dW1 and dW2f split over the rows (``gemm.split_k_rows``), the
    depthwise backward and the LN1 backward."""
    M, smem, tile = B * T, gemm.smem_bytes(dtype), gemm.TILE

    def product(name, N, rows, K=None):
        z = 1 if K is None else -(-K // gemm.split_k_rows((C // tile) * (F // tile), K))
        return FFNLaunch(name, tile, gemm.CHUNK, 2, smem, (N // tile, -(-rows // tile), z), 256)

    def dw(name, smem_rows):
        return FFNLaunch(name, _CHAIN_DW_ROWS, 0, 0, smem_rows * _CHAIN_DW_CH * 4,
                         (-(-T // _CHAIN_DW_ROWS), C // _CHAIN_DW_CH, B), 256)

    def rows(name, per, smem=0):
        return FFNLaunch(name, per, 0, 0, smem, (-(-M // per), 1, 1), 256)

    window = _CHAIN_DW_ROWS + k - 1
    ln = "wide_ln{}{}_long_kernel" if C > LANE_MAX_C else "wide_ln{}{}_kernel"
    fwd = (rows(ln.format(1, ""), _CHAIN_WARP_ROWS), dw("wide_dw_kernel", window),
           product("gemm_up", F, M), product("gemm_down", C, M))
    if mode != "bwd":
        return fwd + (rows(ln.format(2, ""), _CHAIN_WARP_ROWS),)
    return fwd + (rows(ln.format(2, "_bwd"), _CHAIN_RED_ROWS, 3 * C * 4),
                  product("gemm_dup", F, M), product("gemm_dacc", C, M),
                  product("gemm_dw1", F, C, M), product("gemm_dw2f", C, F, M),
                  dw("wide_dw_bwd_kernel", 2 * window + k + 1),
                  rows(ln.format(1, "_bwd"), _CHAIN_RED_ROWS, 2 * C * 4))


def _f32_rows(B: int, T: int) -> int:
    """Rows a split-TF32 block owns: of 64 and 32, the one whose blocks take
    fewer rows' time in waves over the card's SMs (one block an SM), 64 on
    a tie (half the weight streaming and reductions a row)."""
    return min(_F32_ROWS, key=lambda r: -(-B * -(-T // r) // SM_COUNT) * r)


@functools.lru_cache(maxsize=256)
def ffn_plan(C: int, F: int, k: int, B: int, T: int, dtype: torch.dtype,
             mode: str) -> Tuple[FFNLaunch, ...]:
    """Every launch of one call, in order: ``mode`` "serve" (``ffn_ln``),
    "train" (``ffn_ln_train``'s forward) or "bwd" (its backward: the chain,
    the dup pass, the dt1 pass). Serving at C in ``WIDE_C`` runs, in both
    dtypes, ``ffn_wide_kernel`` then ``ffn_wide_ln2_kernel``: blocks of 64
    rows (bf16, wgmma) or 32 (f32, split TF32) that stream the weights once
    a block, 32 F columns a chunk, by bulk copies (bf16: a W1 part and each
    warpgroup's W2f boxes a copy; f32: 16 KB slabs through a ring of six),
    each copy shared by a cluster of 2 or 4 row tiles (multicast); F split
    across grid z when B T is small (``_wide_split``: the card filled, the
    image read about once a cluster); the splits' f32 partial sums added in
    a fixed order by the LN2 pass, up to 8 warps a row
    (``_wide_ln2_warps``). Otherwise bf16 runs the wgmma kernels: 128-row
    blocks for the forward, the chain and the dup pass (64-column F
    chunks, two weight buffers). f32 runs the split-TF32 kernels: blocks
    of 64 or 32 rows (``_f32_rows``) with 32-column F chunks for the
    forward and the chain, 16-column for the dup pass. The dt1 pass takes
    64-row blocks in both. Every block owns the rows its products form.
    Training from C = 384, and serving from C = 768, run
    ``csrc/ffn_wide.cu``'s chain (``on_chain``, ``_chain_plan``)."""
    def grid(rows):
        return (-(-T // rows), B, 1)

    bf16 = dtype == torch.bfloat16
    if on_chain(C, mode):
        return _chain_plan(C, F, k, B, T, dtype, mode)
    if C in WIDE_C and mode == "serve":
        R, _, ns, threads = _wide_geometry(C, dtype)
        x, m, splits = _wide_split(B, T, R, F // _WIDE_FC)
        return (FFNLaunch("ffn_wide_kernel", R, _WIDE_FC, ns, _wide_smem(C, k, dtype),
                          (x, B, splits), threads, m),
                FFNLaunch("ffn_wide_ln2_kernel", 8 // _wide_ln2_warps(splits), 0, 0, 0,
                          (-(-B * T // (8 // _wide_ln2_warps(splits))), 1, 1), 256))
    if bf16:
        fwd = FFNLaunch("ffn_ln_kernel", _ROWS, _FC, 2, _fwd_smem(C, k), grid(_ROWS), _THREADS)
    else:
        r = _f32_rows(B, T)
        fwd = FFNLaunch("ffn_tf32_kernel", r, _F32_FC, 2, _f32_fwd_smem(r, C, k), grid(r),
                        _THREADS)
    if mode != "bwd":
        return (fwd,)
    dup = (FFNLaunch("ffn_dup_kernel", _ROWS, _FC, 2, _dup_smem(C), grid(_ROWS), _THREADS)
           if bf16 else
           FFNLaunch("ffn_dup_tf32_kernel", fwd.rows, _DUP_FC, 2, _f32_dup_smem(fwd.rows, C),
                     fwd.grid, _THREADS))
    return (fwd, dup,
            FFNLaunch("ffn_dt1_kernel", _DT1_ROWS, 0, 0, _dt1_smem(C, k, 2 if bf16 else 4),
                      grid(_DT1_ROWS), _DT1_THREADS))


def _fits(launch: FFNLaunch, k: int) -> bool:
    """Whether a launch fits a block: its shared memory, in f32 the t1
    window of the forward's two piece buffers, in the wide kernel the
    window rows whose z pieces its threads hold (8 a row, 8 a thread), and
    in the chain's depthwise kernels k up to 63."""
    window = {"ffn_tf32_kernel": _F32_WINDOW,
              "ffn_wide_kernel": _WIDE_PIECES * 256 // 8}.get(launch.kernel)
    if launch.kernel in ("wide_dw_kernel", "wide_dw_bwd_kernel") and k > _CHAIN_MAX_K:
        return False
    return launch.smem_bytes <= SMEM_LIMIT and (window is None or launch.rows + k - 1 <= window)


def ffn_train_fits(C: int, F: int, k: int, dtype: torch.dtype) -> bool:
    """Whether the training kernels take these widths on the card: the card's
    own counterpart of the JAX package's VMEM estimate (``_fused_ffn_ok``).
    Every launch of the forward and the backward must fit a block (at both
    f32 row counts); k is at most 63 in bf16 and 50 in f32 (the dt1 tile at
    C = 256), at every width; C at every multiple of 128 (past
    ``LANE_MAX_C`` the chain's row kernels read their rows again)."""
    if dtype not in _MAX_K or not train_ok(C) or F % 128 != 0:
        return False
    if not 1 <= k <= _MAX_K[dtype]:
        return False
    shapes = ((1, 1), (1, 64 * SM_COUNT))  # the 32-row and the 64-row f32 plan
    return all(_fits(p, k) for B, T in shapes
               for mode in ("train", "bwd") for p in ffn_plan(C, F, k, B, T, dtype, mode))


@functools.lru_cache(maxsize=16)
def _image_index(C: int, F: int, device: torch.device) -> torch.Tensor:
    """For each element of ``_weight_image``'s (F / 64, 2 CP 64) layout, its
    source in ``cat(W1.flatten(), W2f.flatten(), [0])``: per 64-column chunk
    of F, W1[:, chunk] as CP rows of 64, then W2f[chunk, :] as CP / 64 boxes
    of 64 rows by 64 channels; each row of 64 two-byte elements in the
    128-byte swizzle the kernels' descriptors read (16-byte piece q of row r
    at q ^ (r % 8)); channels past C take the zero (CP = max(C, 64))."""
    cp, n = _cp(C), F // _FC
    zero = 2 * C * F
    q = torch.arange(8)
    # W1 part: element (c, piece q, e) of chunk i holds W1[c, 64 i + 8 (q ^ c % 8) + e]
    c = torch.arange(cp)[:, None, None]
    f = 8 * (q[None, :, None] ^ (c % 8)) + torch.arange(8)[None, None, :]
    i = torch.arange(n)[:, None, None, None]
    w1_src = torch.where(c < C, c * F + _FC * i + f, zero)                  # (n, cp, 8, 8)
    # W2f part: box j, row (f) r, piece q, e holds W2f[64 i + r, 64 j + 8 (q ^ r % 8) + e]
    j = torch.arange(cp // 64)[:, None, None, None]
    r = torch.arange(_FC)[None, :, None, None]
    cc = 64 * j + 8 * (q[None, None, :, None] ^ (r % 8)) + torch.arange(8)[None, None, None, :]
    i2 = torch.arange(n)[:, None, None, None, None]
    w2_src = torch.where(cc < C, C * F + (_FC * i2 + r) * C + cc, zero)    # (n, cp/64, 64, 8, 8)
    return torch.cat([w1_src.reshape(n, -1), w2_src.reshape(n, -1)], 1).to(device)


def _weight_image(w1: torch.Tensor, w2f: torch.Tensor) -> torch.Tensor:
    """W1 (C, F) and W2f (F, C) as the bf16 kernels stream them
    (``_image_index``): a (F / 64, 2 CP 64) bf16 tensor, one gather."""
    C, F = w1.shape
    src = torch.cat([w1.reshape(-1), w2f.reshape(-1), w1.new_zeros(1)]).to(torch.bfloat16)
    return src[_image_index(C, F, w1.device)]


@functools.lru_cache(maxsize=16)
def _wide_index(C: int, F: int, device: torch.device) -> torch.Tensor:
    """For each element of ``_wide_image``'s (F / 32, 2, C / 64, 32, 64)
    layout, its source in ``cat(W1^T.flatten(), W2f.flatten())`` (both
    (F, C)): per 32-column chunk i of F a W1 part and a W2f part, each C /
    64 boxes of 32 rows (f) by 64 channels, a row 128 bytes in the
    128-byte swizzle (16-byte piece q of row r at q ^ (r % 8)): box b of
    part p holds X_p[32 i + r, 64 b + 8 (q ^ r % 8) + e]. The W1 boxes are
    the up product's B K-major, the W2f boxes the down product's B
    MN-major."""
    n = F // _WIDE_FC
    i = torch.arange(n)[:, None, None, None, None, None]
    p = torch.arange(2)[None, :, None, None, None, None]
    b = torch.arange(C // 64)[None, None, :, None, None, None]
    r = torch.arange(_WIDE_FC)[None, None, None, :, None, None]
    q = torch.arange(8)[None, None, None, None, :, None]
    e = torch.arange(8)[None, None, None, None, None, :]
    src = p * F * C + (_WIDE_FC * i + r) * C + 64 * b + 8 * (q ^ (r % 8)) + e
    return src.reshape(n, -1).to(device)


def _wide_image(w1: torch.Tensor, w2f: torch.Tensor) -> torch.Tensor:
    """W1 (C, F) and W2f (F, C) as the bf16 ``ffn_wide_kernel`` streams
    them (``_wide_index``): a (F / 32, 64 C) bf16 tensor, one gather; a
    chunk's 2 C / 64 boxes of 4 KB are its tiles in ring order."""
    C, F = w1.shape
    src = torch.cat([w1.t().reshape(-1), w2f.reshape(-1)]).to(torch.bfloat16)
    return src[_wide_index(C, F, w1.device)]


@functools.lru_cache(maxsize=16)
def _wide_f32_index(C: int, F: int, device: torch.device) -> torch.Tensor:
    """For each element of ``_wide_f32_image``'s layout, its source in
    ``_split_source``'s [hi(W1), hi(W2f), lo(W1), lo(W2f)]: per 32-column
    chunk a W1 part (K = C, N = 32) as C / 64 slabs of 8 k-steps by 4 n8
    tiles, then a W2f part (K = 32, N = C) as C / 64 slabs of 4 k-steps by
    the 8 n8 tiles of 64 channels; a slab in ``_frag_order`` (k-step, n8
    tile, lane, a lane's two hi values before its two lo ones), 16 KB."""
    n = F // _WIDE_FC
    w1 = torch.arange(C * F).reshape(C, n, _WIDE_FC).permute(1, 0, 2)     # (chunk, C, 32)
    w2 = (C * F + torch.arange(F * C)).reshape(n, _WIDE_FC, C)             # (chunk, 32, C)
    o1 = _frag_order(w1)                                                   # (n, C/8, 4, 8, 4, 2)
    o2 = _frag_order(w2).reshape(n, 4, C // 64, 8, 8, 4, 2).permute(0, 2, 1, 3, 4, 5, 6)
    out = [torch.stack([o, o + 2 * C * F], dim=-2).reshape(n, -1) for o in (o1, o2)]
    return torch.stack(out, dim=1).to(device)


def _wide_f32_image(w1: torch.Tensor, w2f: torch.Tensor) -> torch.Tensor:
    """W1 (C, F) and W2f (F, C) as the f32 ``ffn_wide_kernel`` streams them
    (``_wide_f32_index``): a (F / 32, 2, 64 C) f32 tensor of TF32 hi / lo
    halves, one gather; a chunk's 2 C / 64 slabs of 16 KB are its tiles in
    ring order."""
    C, F = w1.shape
    return _split_source(w1, w2f)[_wide_f32_index(C, F, w1.device)]


def _frag_order(x: torch.Tensor) -> torch.Tensor:
    """(..., K, N) product operands in ``mma.sync``'s B-fragment order, as
    the f32 kernels read them: per k-step s of 8 rows, n8 tile j and lane
    4 g + t, rows 8 s + 2 t and 8 s + 2 t + 1 at column 8 j + g
    (csrc/ffn_sm90.cuh: rows 2t, 2t + 1 of a k-step are the product's k
    indices t, t + 4). Returns (..., K / 8, N / 8, 8, 4, 2)."""
    *lead, K, N = x.shape
    n = len(lead)
    order = tuple(range(n)) + tuple(n + d for d in (0, 3, 4, 1, 2))
    return x.reshape(*lead, K // 8, 4, 2, N // 8, 8).permute(order)


@functools.lru_cache(maxsize=16)
def _f32_index(C: int, F: int, which: str, device: torch.device) -> torch.Tensor:
    """For each element of ``_f32_image``'s layout, its source in
    ``_split_source``'s [hi(W1), hi(W2f), lo(W1), lo(W2f)]: per chunk of fc
    F columns its pieces, each in ``_frag_order`` with a lane's two hi
    values before its two lo ones."""
    fc = _F32_FC if which == "fwd" else _DUP_FC
    w1 = torch.arange(C * F).reshape(C, F // fc, fc).permute(1, 0, 2)          # (chunk, C, fc)
    w2 = (C * F + torch.arange(F * C)).reshape(F // fc, fc, C)                 # (chunk, fc, C)
    pieces = (w1, w2) if which == "fwd" else (w1, w2.transpose(1, 2), w1.transpose(1, 2))
    out = []
    for x in pieces:
        o = _frag_order(x)
        out.append(torch.stack([o, o + 2 * C * F], dim=-2).reshape(F // fc, -1))
    return torch.stack(out, dim=1).to(device)


def _split_source(w1: torch.Tensor, w2f: torch.Tensor) -> torch.Tensor:
    """W1 and W2f split into TF32 halves, hi = tf32(w), lo = tf32(w - hi)
    (hi + lo is w within 2^-22 of |w|): [hi(W1), hi(W2f), lo(W1), lo(W2f)]
    flattened, f32."""
    w = torch.cat([w1.float().reshape(-1), w2f.float().reshape(-1)])
    hi = tf32(w)
    return torch.cat([hi, tf32(w - hi)])


def _f32_image(w1: torch.Tensor, w2f: torch.Tensor, which: str,
               src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W1 (C, F) and W2f (F, C) as the f32 kernels stream them, one gather
    from their split halves (``src``, ``_split_source``'s, made here when
    not given): a (F / fc, pieces, C fc 2) f32 tensor, per chunk of fc F
    columns "fwd" (``ffn_tf32_kernel``, fc 32) a W1 piece (K = C, N = fc)
    and a W2f piece (K = fc, N = C), "dup" (``ffn_dup_tf32_kernel``, fc 16)
    W1 (K = C, N = fc), W2f^T (K = C, N = fc) and W1^T (K = fc, N = C); a
    piece in ``_frag_order``, a lane's two hi values before its lo ones."""
    C, F = w1.shape
    src = _split_source(w1, w2f) if src is None else src
    return src[_f32_index(C, F, which, w1.device)]


# ---------------------------------------------------------------------------
# training half: the same fusion plus two hashed dropouts, and its backward
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, a: int) -> torch.Tensor:
    """``(x * a) mod 2**32`` for int64 tensors holding uint32 values, in
    16-bit halves so no int64 product overflows."""
    lo = x * (a & 0xFFFF)
    hi = ((x * (a >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix(x: torch.Tensor) -> torch.Tensor:
    """The xorshift-multiply finalizer of both dropout hashes."""
    x = x ^ (x >> 16)
    x = _mul32(x, 2246822519)
    x = x ^ (x >> 13)
    x = _mul32(x, 3266489917)
    return x ^ (x >> 16)


def keep_threshold(rate: float) -> int:
    """Keep an element when its hash is >= this (keep probability 1 - rate)."""
    return min(int(rate * (2.0 ** 32)), 2 ** 32 - 1)


def ffn_keep_mask(gpos: torch.Tensor, n_cols: int, rate: float, seed_u32,
                  salt: int) -> torch.Tensor:
    """``_pos_keep`` of ``ops/pallas_ffn.py`` bit for bit: a (..., R, n_cols)
    keep mask from global row positions ``gpos`` (R,) (negative rows wrap to
    uint32, as there), column index, ``seed_u32`` (an int or an int64 tensor
    that broadcasts against (R, n_cols)) and ``salt``. The mix is
    ``(r * 2654435761) ^ (c + 0x9E3779B9 * salt)``, then ``+ seed``."""
    r = gpos.to(torch.int64) & _M32
    c = torch.arange(n_cols, dtype=torch.int64, device=gpos.device)
    x = _mul32(r, 2654435761)[:, None] ^ ((c + 0x9E3779B9 * salt) & _M32)[None, :]
    x = (x + seed_u32) & _M32
    return _fmix(x) >= keep_threshold(rate)


def batch_seeds(seed: torch.Tensor, batch: int) -> torch.Tensor:
    """Per-item uint32 seeds ``seed + b * 2654435761`` (``_seed_u32``) as a
    (B, 1, 1) int64 tensor."""
    b = torch.arange(batch, dtype=torch.int64, device=seed.device)
    s = (seed.to(torch.int64).reshape(()) & _M32) + _mul32(b, 2654435761)
    return (s & _M32)[:, None, None]


def ffn_train_params(conv1_depth, conv1_point, conv2_group, conv2_point,
                     norm1, norm2):
    """The block's f32 parameters in the training kernel's layouts, built
    inside the autograd graph (views, and the grouped-conv fold as
    differentiable ops), so gradients reach the modules' parameters in f32:
    ``(wd (k, C), bd, w1 (C, F), b1, w2f (F, C), b2f, g1, be1, g2, be2)``."""
    C = conv1_depth.weight.shape[0]
    w2f, b2f = fold_grouped_into_down(
        conv2_group.weight, conv2_group.bias, conv2_point.weight,
        conv2_point.bias, groups=C)
    return (conv1_depth.weight[:, 0, :].t(), conv1_depth.bias,
            conv1_point.weight[:, :, 0].t(), conv1_point.bias, w2f, b2f,
            norm1.weight, norm1.bias, norm2.weight, norm2.bias)


def _rnd(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dt``'s precision but kept f32; the gradient passes
    through unrounded, as the kernels keep every gradient in f32."""
    if dt == torch.float32:
        return x
    return x + (x.to(dt).float() - x).detach()


def ffn_ln_train_plain(z: torch.Tensor, p, seed: torch.Tensor, rate: float,
                       eps: float = 1e-5) -> torch.Tensor:
    """Plain, autograd-differentiable version of the training kernel: the
    serving half's rounding points, keep1 (salt 1) on the (T, F) ReLU
    output and keep2 (salt 2) on the (T, C) FFN output, kept values scaled
    by 1 / (1 - rate)."""
    wd, bd, w1, b1, w2f, b2f, g1, be1, g2, be2 = p
    dt = z.dtype
    B, T, _ = z.shape
    F = w1.shape[1]
    f32 = torch.float32
    inv_keep = 1.0 / (1.0 - rate)
    seeds = batch_seeds(seed, B)
    gpos = torch.arange(T, device=z.device)
    t1 = _rnd(layer_norm_fn(z, g1, be1, f32, eps), dt)
    h0 = _rnd(depthwise_conv1d(t1, wd.t().unsqueeze(1).float(), bd.float()), dt)
    up = _rnd(torch.relu(h0 @ _rnd(w1.float(), dt) + b1.float()), dt)
    keep1 = ffn_keep_mask(gpos, F, rate, seeds, 1)
    up = _rnd(torch.where(keep1, up * inv_keep, 0.0), dt)
    ff = up @ _rnd(w2f.float(), dt) + b2f.float()
    keep2 = ffn_keep_mask(gpos, ff.shape[-1], rate, seeds, 2)
    ff = torch.where(keep2, ff * inv_keep, 0.0)
    return layer_norm_fn(t1 + ff, g2, be2, dt, eps)


def _ln_bwd(x: torch.Tensor, dy_g: torch.Tensor, eps: float):
    """dx of y_hat = (x - mean) / sigma given dy_g = dy * gamma (f32, stats
    over the last axis), and x_hat: the kernels' LayerNorm backward."""
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    xh = (x - mean) * inv
    dx = inv * (dy_g - dy_g.mean(-1, keepdim=True) - xh * (dy_g * xh).mean(-1, keepdim=True))
    return dx, xh


def ffn_ln_train_bwd_plain(dout: torch.Tensor, z: torch.Tensor, p, seed: torch.Tensor,
                           rate: float, eps: float = 1e-5):
    """The bf16 kernels' backward in plain PyTorch, stage by stage, with
    their rounding points (the working dtype's: none in f32). Returns what
    ``ffn_ln_train_bwd`` returns: dz and the f32 gradients of ``p``.

    (a) the chain: the forward again, then the LN2 backward: dres, and
        dff = keep2 dres / (1 - r), rounded for the products; dg2, dbe2, db2f
        (of the unrounded dff).
    (b) dup = keep1 relu'(h0 W1 + b1) (dff W2f^T) / (1 - r), rounded for the
        products (db1 sums it unrounded); dacc = dup W1^T; dW1 = h0^T dup;
        dW2f = up_d^T dff with up_d the dropped, rounded ReLU output.
    (c) dt1 = dres + the depthwise backward of dacc; dwd, dbd; the LN1
        backward into dz; dg1, dbe1."""
    f32 = torch.float32
    wd, bd, w1, b1, w2f, b2f, g1, be1, g2, be2 = (t.detach().float() for t in p)
    dt = z.dtype
    rnd = (lambda x: x) if dt == f32 else (lambda x: x.to(dt).float())
    B, T, C = z.shape
    k, F = wd.shape[0], w1.shape[1]
    lpad, rpad = (k - 1) // 2, k - 1 - (k - 1) // 2
    ik = 1.0 / (1.0 - rate)
    seeds = batch_seeds(seed, B)
    gpos = torch.arange(T, device=z.device)
    keep1 = ffn_keep_mask(gpos, F, rate, seeds, 1)
    keep2 = ffn_keep_mask(gpos, C, rate, seeds, 2)
    zf, dy = z.detach().float(), dout.detach().to(dt).float()
    w1r, w2r = rnd(w1), rnd(w2f)
    rows = (0, 1)
    # (a)
    t1 = rnd(layer_norm_fn(zf, g1, be1, f32, eps))
    h0 = rnd(depthwise_conv1d(t1, wd.t().unsqueeze(1), bd))
    pre = h0 @ w1r + b1
    up_d = rnd(torch.where(keep1, rnd(torch.relu(pre)) * ik, 0.0))
    ff = torch.where(keep2, (up_d @ w2r + b2f) * ik, 0.0)
    dres, xh2 = _ln_bwd(t1 + ff, dy * g2, eps)
    dff = torch.where(keep2, dres * ik, 0.0)
    dg2, dbe2, db2f = (dy * xh2).sum(rows), dy.sum(rows), dff.sum(rows)
    dffr = rnd(dff)
    # (b)
    dup = torch.where(keep1 & (pre > 0), (dffr @ w2r.t()) * ik, 0.0)
    db1 = dup.sum(rows)
    dupr = rnd(dup)
    dacc = dupr @ w1r.t()
    dw1 = torch.einsum("btc,btf->cf", h0, dupr)
    dw2f = torch.einsum("btf,btc->fc", up_d, dffr)
    # (c): dt1[t] = dres[t] + sum_j dacc[t - j + lpad] wd[j];
    #      dwd[j] = sum_e t1[e + j - lpad] dacc[e]
    dacc_p = nnf.pad(dacc, (0, 0, rpad, lpad))
    t1_p = nnf.pad(t1, (0, 0, lpad, rpad))
    dt1 = dres + sum(dacc_p[:, k - 1 - j:k - 1 - j + T] * wd[j] for j in range(k))
    dwd = torch.stack([(t1_p[:, j:j + T] * dacc).sum(rows) for j in range(k)])
    dbd = dacc.sum(rows)
    dz, xh1 = _ln_bwd(zf, dt1 * g1, eps)
    dg1, dbe1 = (dt1 * xh1).sum(rows), dt1.sum(rows)
    return (dz.to(dt), dwd, dbd, dw1, db1, dw2f, db2f, dg1, dbe1, dg2, dbe2)


def _check_train(z: torch.Tensor, k: int, F: int) -> None:
    B, T, C = z.shape
    if not ffn_train_fits(C, F, k, z.dtype):
        raise ValueError(
            f"ffn_ln_train kernels take f32 or bf16 z, C in {NARROW_C} or a multiple of 128 "
            f"from {CHAIN_MIN_C} (the chain of csrc/ffn_wide.cu), "
            f"F % 128 == 0 and k <= "
            f"{_MAX_K.get(z.dtype, 0)} within {SMEM_LIMIT} bytes of shared memory; "
            f"got {z.dtype}, C={C}, F={F}, k={k}")


def _kernel_layouts(p, dt: torch.dtype) -> Dict[str, torch.Tensor]:
    """The kernels' weight layouts of one training call, for the forward and
    the backward alike: the f32 taps, biases and LayerNorm vectors, and W1,
    W2f as the kernels stream them: bf16 one swizzled image ("img", the
    forward, the chain and the dup pass); f32 the forward's and the chain's
    split pieces ("img") and the dup pass's ("dup_img"). At C from
    384 W1 (C, F) and W2f (F, C) as they lie ("w1", "w2f", the
    backward's dup and dacc products) and their transposes
    (``_chain_image``, "img", the up and down products), in the working
    dtype: ``csrc/ffn_wide.cu`` reads them so, f32 split as read."""
    wd, bd, w1, b1, w2f, b2f, g1, be1, g2, be2 = (t.detach() for t in p)
    lnp = torch.stack([g1.float(), be1.float(), g2.float(), be2.float(),
                       bd.float(), b2f.float()]).contiguous()
    out = dict(wd=wd.float().contiguous(), b1=b1.float().contiguous(), lnp=lnp)
    if on_chain(w1.shape[0], "train"):
        out.update(w1=w1.to(dt).contiguous(), w2f=w2f.to(dt).contiguous(),
                   img=_chain_image(w1, w2f, dt))
    elif dt == torch.bfloat16:
        out["img"] = _weight_image(w1, w2f)
    else:
        src = _split_source(w1, w2f)
        out.update(img=_f32_image(w1, w2f, "fwd", src), dup_img=_f32_image(w1, w2f, "dup", src))
    return out


def _chain_image(w1: torch.Tensor, w2f: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """W1 (C, F) and W2f (F, C) as the chain's forward products read them:
    W1^T (F, C) then W2f^T (C, F), flat, in ``dtype`` (each the B operand of
    its product, k-contiguous)."""
    return torch.cat([w1.t().reshape(-1), w2f.t().reshape(-1)]).to(dtype).contiguous()


def _chain_fwd(z: torch.Tensor, wd, b1, lnp, img, F: int, seed: Optional[torch.Tensor],
               eps: float, thr: int, ik: float, stream: int) -> torch.Tensor:
    """``csrc/ffn_wide.cu``'s forward on z (B, T, C) with ``_chain_image``'s
    weights: serving (``seed`` None, no dropout) or the training forward,
    with its scratch."""
    global _c_chain_fwd
    if _c_chain_fwd is None:
        _c_chain_fwd = _lib_fn("ffn_wide", "lfs2_ffn_wide_fwd",
                               [_P] * 12 + [_I] * 5 + [_F, _U, _F, _I, _I, _P])
    B, T, C = z.shape
    k = wd.shape[0]
    out, t1, h0 = (torch.empty_like(z) for _ in range(3))
    up = z.new_empty(B, T, F)
    ff = torch.empty(B, T, C, dtype=torch.float32, device=z.device)
    lib, fn = _c_chain_fwd
    w1t, w2ft = img[:F * C], img[F * C:]
    rc = fn(z.data_ptr(), out.data_ptr(), wd.data_ptr(), b1.data_ptr(), lnp.data_ptr(),
            w1t.data_ptr(), w2ft.data_ptr(), None if seed is None else seed.data_ptr(),
            t1.data_ptr(), h0.data_ptr(), up.data_ptr(), ff.data_ptr(), B, T, C, F, k, eps,
            thr, ik, int(seed is not None), build.DTYPE_CODES[z.dtype], stream)
    build.check(lib, rc, "ffn_wide (forward)")
    return out


def _chain_bwd(dout, z, w, seed, eps, thr, ik, stream, dz, grads) -> None:
    """``csrc/ffn_wide.cu``'s backward: dz and the gradients added into the
    zeroed ``grads`` views (dwd, dw1, dw2f, db1, dvec)."""
    global _c_chain_bwd
    if _c_chain_bwd is None:
        _c_chain_bwd = _lib_fn("ffn_wide", "lfs2_ffn_wide_bwd",
                               [_P] * 24 + [_I] * 5 + [_F, _U, _F, _I, _P])
    B, T, C = z.shape
    k, F = w["wd"].shape[0], w["w1"].shape[1]
    t1, h0, dff = (torch.empty_like(z) for _ in range(3))
    up, dup = z.new_empty(B, T, F), z.new_empty(B, T, F)
    ff, dres, dacc = (torch.empty(B, T, C, dtype=torch.float32, device=z.device)
                      for _ in range(3))
    lib, fn = _c_chain_bwd
    w1t, w2ft = w["img"][:F * C], w["img"][F * C:]
    rc = fn(z.data_ptr(), dout.data_ptr(), w["wd"].data_ptr(), w["b1"].data_ptr(),
            w["lnp"].data_ptr(), w["w1"].data_ptr(), w["w2f"].data_ptr(), w1t.data_ptr(),
            w2ft.data_ptr(), seed.data_ptr(),
            t1.data_ptr(), h0.data_ptr(), up.data_ptr(), ff.data_ptr(), dres.data_ptr(),
            dff.data_ptr(), dup.data_ptr(), dacc.data_ptr(), dz.data_ptr(),
            *(g.data_ptr() for g in grads), B, T, C, F, k, eps, thr, ik,
            build.DTYPE_CODES[z.dtype], stream)
    build.check(lib, rc, "ffn_wide (backward)")


def _train_fn():
    global _c_train
    if _c_train is None:
        _c_train = _lib_fn("ffn_ln", "lfs2_ffn_ln_train",
                           [_P] * 7 + [_I] * 6 + [_F, _U, _F, _I, _P])
    return _c_train


def _chain_fn():
    global _c_chain
    if _c_chain is None:
        _c_chain = _lib_fn("ffn_ln", "lfs2_ffn_ln_chain",
                           [_P] * 11 + [_I] * 6 + [_F, _U, _F, _I, _P])
    return _c_chain


def _bwd_fn():
    global _c_bwd
    if _c_bwd is None:
        _c_bwd = _lib_fn("ffn_ln_train_bwd", "lfs2_ffn_ln_train_bwd",
                         [_P] * 16 + [_I] * 6 + [_F, _U, _F, _I, _P])
    return _c_bwd


def ffn_ln_train_fwd(z: torch.Tensor, p, seed: torch.Tensor, rate: float,
                     eps: float = 1e-5, layouts: Optional[Dict[str, torch.Tensor]] = None
                     ) -> torch.Tensor:
    """Launch the training forward kernel (``csrc/ffn_ln.cu``, dropout on;
    from C = 384 the chain of ``csrc/ffn_wide.cu``); CUDA tensors only.
    ``layouts`` (``_kernel_layouts``) are built here when
    not given. The result is not connected to autograd."""
    k, F = p[0].shape[0], p[2].shape[1]
    _check_train(z, k, F)
    w = _kernel_layouts(p, z.dtype) if layouts is None else layouts
    stream = kernel_stream(z, seed, *w.values())
    B, T, C = z.shape
    if on_chain(C, "train"):
        out = _chain_fwd(z, w["wd"], w["b1"], w["lnp"], w["img"], F, seed, eps,
                         keep_threshold(rate), 1.0 / (1.0 - rate), stream)
    else:
        rows = ffn_plan(C, F, k, B, T, z.dtype, "train")[0].rows
        out = torch.empty_like(z)
        lib, fn = _train_fn()
        rc = fn(z.data_ptr(), out.data_ptr(), w["wd"].data_ptr(), w["b1"].data_ptr(),
                w["lnp"].data_ptr(), w["img"].data_ptr(), seed.data_ptr(), B, T, C, F, k, rows,
                eps, keep_threshold(rate), 1.0 / (1.0 - rate), build.DTYPE_CODES[z.dtype],
                stream)
        build.check(lib, rc, "ffn_ln_train")
    ffn_ln_train.launches += 1
    ffn_ln_train.by_width[C] = ffn_ln_train.by_width.get(C, 0) + 1
    return out


def ffn_ln_train_bwd(dout: torch.Tensor, z: torch.Tensor, p, seed: torch.Tensor,
                     rate: float, eps: float = 1e-5,
                     layouts: Optional[Dict[str, torch.Tensor]] = None):
    """Launch the backward (CUDA tensors only): the chain
    (``csrc/ffn_ln.cu``), then the dup and dt1 passes
    (``csrc/ffn_ln_train_bwd.cu``), through (B, T, C) scratch h0, dff (the
    working dtype), dres and dacc (f32), each launch sized by ``ffn_plan``;
    from C = 384 the eleven launches of ``csrc/ffn_wide.cu``.
    Returns ``dz`` and the f32 gradients of the ten entries of ``p``, in
    order."""
    k, F = p[0].shape[0], p[2].shape[1]
    _check_train(z, k, F)
    w = _kernel_layouts(p, z.dtype) if layouts is None else layouts
    dout = dout.to(z.dtype).contiguous()
    stream = kernel_stream(z, dout, seed, *w.values())
    B, T, C = z.shape
    dz = torch.empty_like(z)
    # one zeroed f32 buffer for every weight gradient: the blocks add their
    # tile's contribution with atomics
    sizes = (k * C, C * F, F * C, F, 6 * C)
    grads = torch.zeros(sum(sizes), dtype=torch.float32, device=z.device)
    dwd, dw1, dw2f, db1, dvec = torch.split(grads, sizes)
    thr, ik = keep_threshold(rate), 1.0 / (1.0 - rate)
    if on_chain(C, "bwd"):
        _chain_bwd(dout, z, w, seed, eps, thr, ik, stream, dz, (dwd, dw1, dw2f, db1, dvec))
    else:
        _narrow_bwd(dout, z, w, seed, eps, thr, ik, stream, dz, (dwd, dw1, dw2f, db1, dvec))
    ffn_ln_train_bwd.launches += 1
    ffn_ln_train_bwd.by_width[C] = ffn_ln_train_bwd.by_width.get(C, 0) + 1
    dg1, dbe1, dg2, dbe2, dbd, db2f = dvec.view(6, C)
    return (dz, dwd.view(k, C), dbd, dw1.view(C, F), db1, dw2f.view(F, C),
            db2f, dg1, dbe1, dg2, dbe2)


def _narrow_bwd(dout, z, w, seed, eps, thr, ik, stream, dz, grads) -> None:
    """The backward's three launches at C in ``NARROW_C``: the chain, then
    the dup and dt1 passes."""
    dwd, dw1, dw2f, db1, dvec = grads
    B, T, C = z.shape
    k, F = w["wd"].shape[0], db1.numel()
    code = build.DTYPE_CODES[z.dtype]
    chain, dup, _ = ffn_plan(C, F, k, B, T, z.dtype, "bwd")
    h0, dff = torch.empty_like(z), torch.empty_like(z)
    dres = torch.empty(B, T, C, dtype=torch.float32, device=z.device)
    dacc = torch.empty_like(dres)
    lib, fn = _chain_fn()
    rc = fn(z.data_ptr(), dout.data_ptr(), w["wd"].data_ptr(), w["img"].data_ptr(),
            w["b1"].data_ptr(), w["lnp"].data_ptr(), seed.data_ptr(), h0.data_ptr(),
            dres.data_ptr(), dff.data_ptr(), dvec.data_ptr(), B, T, C, F, k, chain.rows, eps,
            thr, ik, code, stream)
    build.check(lib, rc, "ffn_ln_train_bwd (chain)")
    lib, fn = _bwd_fn()
    rc = fn(z.data_ptr(), dres.data_ptr(), h0.data_ptr(), dff.data_ptr(),
            w["wd"].data_ptr(), w.get("dup_img", w["img"]).data_ptr(), w["b1"].data_ptr(),
            w["lnp"].data_ptr(), seed.data_ptr(), dacc.data_ptr(), dz.data_ptr(),
            dwd.data_ptr(), dw1.data_ptr(), dw2f.data_ptr(), db1.data_ptr(),
            dvec.data_ptr(), B, T, C, F, k, dup.rows, eps, thr, ik, code, stream)
    build.check(lib, rc, "ffn_ln_train_bwd")


def last_launches() -> Dict[str, object]:
    """The latest launches as the libraries recorded them when they were
    accepted, each ``{"grid", "smem_bytes", "rows", "cluster"}``: under
    "ffn_ln" the forward library's latest (a forward, a serving call's
    first launch or the backward's chain), under "ffn_ln_wide_ln2" its
    latest wide LN2 pass, under "ffn_ln_max_active_clusters" the clusters
    the card holds at once at the latest wide launch's configuration
    (cudaOccupancyMaxActiveClusters; 0 after other routes), under
    "ffn_ln_train_bwd" the backward library's latest call (the dup and dt1
    passes), under "ffn_wide" every launch of ``csrc/ffn_wide.cu``'s latest
    call (the chain, ``on_chain``). Zeros before the first."""
    def rec(r, cluster=1):
        return {"grid": (r[0], r[1], r[2]), "smem_bytes": r[3], "rows": r[4], "cluster": cluster}

    fwd = (ctypes.c_int * 12)()
    lib = build.load("ffn_ln")
    lib.lfs2_ffn_ln_last_launch.argtypes = [ctypes.POINTER(ctypes.c_int)]
    build.check(lib, lib.lfs2_ffn_ln_last_launch(fwd), "ffn_ln launch query")
    bwd = (ctypes.c_int * 10)()
    lib = build.load("ffn_ln_train_bwd")
    lib.lfs2_ffn_ln_train_bwd_last_launches.argtypes = [ctypes.POINTER(ctypes.c_int)]
    build.check(lib, lib.lfs2_ffn_ln_train_bwd_last_launches(bwd), "ffn_ln_train_bwd launch query")
    chain = (ctypes.c_int * 81)()
    lib = build.load("ffn_wide")
    lib.lfs2_ffn_wide_last_launches.argtypes = [ctypes.POINTER(ctypes.c_int)]
    build.check(lib, lib.lfs2_ffn_wide_last_launches(chain), "ffn_wide launch query")
    return {"ffn_ln": rec(fwd[:5], fwd[5]),
            "ffn_ln_wide_ln2": rec(fwd[7:12]),
            "ffn_ln_max_active_clusters": fwd[6],
            "ffn_ln_train_bwd": [rec(bwd[5 * i:5 * i + 5]) for i in range(2) if bwd[5 * i]],
            "ffn_wide": [rec(chain[1 + 5 * i:6 + 5 * i]) for i in range(chain[0])]}


def planned_launch(launch: FFNLaunch) -> Dict[str, object]:
    """A plan entry in ``last_launches``' terms, to hold the two together."""
    return {"grid": launch.grid, "smem_bytes": launch.smem_bytes, "rows": launch.rows,
            "cluster": launch.cluster}


class _FFNLnTrain(torch.autograd.Function):
    """Forward and backward kernels joined like the JAX package's custom VJP:
    the forward saves its inputs and the kernel layouts it built; the
    backward recomputes the chain from them."""

    @staticmethod
    def forward(ctx, z, seed, rate, eps, *p):
        w = _kernel_layouts(p, z.dtype)
        ctx.save_for_backward(z, seed, *p)
        ctx.rate, ctx.eps, ctx.layouts = rate, eps, w
        return ffn_ln_train_fwd(z, p, seed, rate, eps, layouts=w)

    @staticmethod
    def backward(ctx, dout):
        z, seed, *p = ctx.saved_tensors
        dz, *dp = ffn_ln_train_bwd(dout, z, p, seed, ctx.rate, ctx.eps, layouts=ctx.layouts)
        return (dz, None, None, None,
                *(g.to(t.dtype) if ctx.needs_input_grad[4 + i] else None
                  for i, (g, t) in enumerate(zip(dp, p))))


def ffn_ln_train(z: torch.Tensor, p, seed: torch.Tensor, rate: float,
                 eps: float = 1e-5) -> torch.Tensor:
    """Training FFN half: LN2(LN1(z) + drop2(ConvFFN(drop1))) for z (B, T, C)
    in f32 or bf16, ``p`` from ``ffn_train_params`` (f32, in the autograd
    graph), ``seed`` a (1,) int32 tensor on z's device, dropout ``rate``.

    CPU tensors take ``ffn_ln_train_plain``; CUDA tensors run the forward
    and backward kernels through an autograd Function and raise on widths
    the kernels do not take. The weight gradients come back in f32."""
    if z.device.type == "cpu":
        return ffn_ln_train_plain(z, p, seed, rate, eps)
    return _FFNLnTrain.apply(z.contiguous(), seed, float(rate), float(eps), *p)


ffn_ln_train.launches = 0
ffn_ln_train_bwd.launches = 0
# launches by channel count C, set to {} with the counts
ffn_ln_train.by_width = {}
ffn_ln_train_bwd.by_width = {}

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
``csrc/ffn_ln_train_bwd.cu``; one CUDA-core kernel in f32) through an
autograd Function, or runs ``ffn_ln_train_plain`` on the CPU. The rounding
points follow the TPU kernel: LN1 output, depthwise output and ReLU output
are rounded to the working dtype; the depthwise taps, both products and
both LayerNorms accumulate in f32. ``ffn_ln_train_bwd_plain`` is the bf16
backward's stages in plain PyTorch, with its rounding points.

``ffn_plan`` sizes every launch of both sources (rows a block owns, F
chunk, weight buffers, shared memory, grid): the table of
``csrc/ffn_sm90.cuh``, which the CUDA sources check with static_asserts and
``last_launches`` reads back from the libraries.

Kernel weight layouts are prepared once, when weights load
(``prepare_ffn_weights``), or once per training call (the autograd
Function keeps the forward's for the backward), not per launch: the
grouped k=1 conv and the down-projection compose into one (F, C) matrix
(``fold_grouped_into_down``), and the bf16 kernels read W1 and W2f as one
pre-swizzled image (``_weight_image``).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as nnf

from lightningfastspeech2_tpu_torch.kernels import build
from lightningfastspeech2_tpu_torch.kernels.launch import kernel_stream
from lightningfastspeech2_tpu_torch.ops.depthwise import depthwise_conv1d
from lightningfastspeech2_tpu_torch.ops.layer_norm import layer_norm_fn

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
_c_fn = None
_c_train = None
_c_chain = None
_c_bwd = None
_c_bwd_bf16 = None


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
    img: Optional[torch.Tensor] = None  # bf16: W1 and W2f as the kernel reads them

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
        _c_fn = _lib_fn("ffn_ln", "lfs2_ffn_ln", [_P] * 8 + [_I] * 5 + [_F, _I, _P])
    return _c_fn


def ffn_ln(z: torch.Tensor, w: FFNWeights) -> torch.Tensor:
    """LN2(LN1(z) + ConvFFN(LN1(z))) for z (B, T, C) in f32 or bf16.

    CPU tensors take ``ffn_ln_plain``; CUDA tensors launch the kernel,
    which takes C in {32, 64, 128, 256} and F a multiple of 128, and
    raises on anything else. The kernel's result is invisible to autograd,
    so on the card it raises when grad mode is on and an input needs a
    gradient."""
    if z.device.type == "cpu":
        return ffn_ln_plain(z, w)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (z, w.wd, w.w1, w.b1, w.w2f, w.lnp)):
        raise RuntimeError(
            "ffn_ln is the deterministic (serving) kernel and has no backward; "
            "train through ffn_ln_train, or call it under torch.no_grad()")
    stream = kernel_stream(z, w.wd, w.w1, w.b1, w.w2f, w.lnp, w.img)
    B, T, C = z.shape
    F = w.w1.shape[1]
    if z.dtype not in build.DTYPE_CODES or w.w1.dtype != z.dtype or w.w2f.dtype != z.dtype:
        raise ValueError(f"ffn_ln takes f32 or bf16 z with weights of the same "
                         f"dtype, got {z.dtype}, {w.w1.dtype}, {w.w2f.dtype}")
    if C not in (32, 64, 128, 256) or F % 128 != 0:
        raise ValueError(f"ffn_ln kernel takes C in (32, 64, 128, 256) and F % 128 "
                         f"== 0, got C={C}, F={F}")
    smem = ffn_plan(C, F, w.kernel_size, B, T, z.dtype, "serve")[0].smem_bytes
    if smem > SMEM_LIMIT:
        raise ValueError(f"ffn_ln kernel: k={w.kernel_size} at C={C} needs {smem} bytes "
                         f"of shared memory, over {SMEM_LIMIT}")
    img = None
    if z.dtype == torch.bfloat16:
        if w.img is None:
            w.img = _weight_image(w.w1, w.w2f)
        img = w.img
    out = torch.empty_like(z)
    lib, fn = _fn()
    rc = fn(z.data_ptr(), out.data_ptr(), w.wd.data_ptr(), w.w1.data_ptr(),
            w.b1.data_ptr(), w.w2f.data_ptr(), w.lnp.data_ptr(),
            None if img is None else img.data_ptr(), B, T, C, F,
            w.kernel_size, w.eps, build.DTYPE_CODES[z.dtype], stream)
    build.check(lib, rc, "ffn_ln")
    ffn_ln.launches += 1
    return out


ffn_ln.launches = 0




# ---------------------------------------------------------------------------
# the launches' geometry: csrc/ffn_sm90.cuh's table (bf16) and the f32 routes'
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232448  # bytes of dynamic shared memory a block may use (H100)
_ROWS = 128          # kRows: rows of one item a wgmma block owns (two warpgroups of 64)
_FC = 64             # kFC: F columns per weight chunk
_THREADS = 256       # kThreads: two warpgroups
_DT1_ROWS = 64       # kDt1Rows: rows a depthwise/LN1-backward block owns
_DT1_THREADS = 256
_MAX_K = {torch.bfloat16: 63, torch.float32: 31}  # kMaxK; the f32 backward's EP - 1
_F32_ROWS, _F32_FC, _F32_THREADS = 32, 128, 256   # ffn_ln_f32_kernel
_F32_EP, _F32_BWD_FC = 32, 64                      # ffn_bwd_kernel


@dataclass(frozen=True)
class FFNLaunch:
    """One kernel launch: the kernel, the rows of one batch item a block
    owns, the F columns per weight chunk, the weight-chunk buffers in flight
    (a W1 and a W2f buffer, each refilled as soon as its chunk is released;
    0 where the weights stream from L2), shared memory a block, grid and
    threads a block."""

    kernel: str
    rows: int
    fchunk: int
    stages: int
    smem_bytes: int
    grid: Tuple[int, int, int]
    threads: int


def _cp(C: int) -> int:
    """Channels as the bf16 kernels' tiles hold them (C = 32 runs as 64)."""
    return max(C, 64)


def _fwd_smem(C: int, k: int) -> int:
    cp, w = _cp(C), _ROWS + k - 1
    return 1024 + 2 * cp * 128 + _ROWS * cp * 2 + max(w * cp * 2, _ROWS * _FC * 2) + w * 8 + 64


def _dup_smem(C: int) -> int:
    cp = _cp(C)
    return 1024 + 2 * cp * 128 + 2 * _ROWS * cp * 2 + 2 * _ROWS * _FC * 2 + 64


def _dt1_smem(C: int, k: int) -> int:
    return (_DT1_ROWS + k - 1) * C * 6


@functools.lru_cache(maxsize=256)
def ffn_plan(C: int, F: int, k: int, B: int, T: int, dtype: torch.dtype,
             mode: str) -> Tuple[FFNLaunch, ...]:
    """Every launch of one call, in order: ``mode`` "serve" (``ffn_ln``),
    "train" (``ffn_ln_train``'s forward) or "bwd" (its backward). bf16 runs
    the tensor-core kernels: 128-row blocks for the forward and the
    backward's chain and dup passes (64-column F chunks, two weight
    buffers), 64-row blocks for the dt1 pass. f32 runs the CUDA-core
    kernels: 32-row forward blocks, and backward blocks that own
    32 - (k - 1) of the 32 rows they recompute."""
    def grid(rows):
        return (-(-T // rows), B, 1)

    if dtype == torch.bfloat16:
        fwd = FFNLaunch("ffn_ln_kernel", _ROWS, _FC, 2, _fwd_smem(C, k), grid(_ROWS), _THREADS)
        if mode != "bwd":
            return (fwd,)
        return (fwd,
                FFNLaunch("ffn_dup_kernel", _ROWS, _FC, 2, _dup_smem(C), grid(_ROWS), _THREADS),
                FFNLaunch("ffn_dt1_kernel", _DT1_ROWS, 0, 0, _dt1_smem(C, k), grid(_DT1_ROWS),
                          _DT1_THREADS))
    if mode != "bwd":
        smem = ((_F32_ROWS + k - 1) * C + _F32_ROWS * C + _F32_ROWS * _F32_FC) * 4
        return (FFNLaunch("ffn_ln_f32_kernel", _F32_ROWS, _F32_FC, 0, smem, grid(_F32_ROWS),
                          _F32_THREADS),)
    ep, tt = _F32_EP, _F32_EP - (k - 1)
    smem = (ep * C * 4 + ep * _F32_BWD_FC * 4 + 2 * ep * C * 4 + (ep + k - 1) * C * 4
            + ep * _F32_BWD_FC * 4)
    return (FFNLaunch("ffn_bwd_kernel", tt, _F32_BWD_FC, 0, smem, grid(max(tt, 1)),
                      _F32_THREADS),)


def ffn_train_fits(C: int, F: int, k: int, dtype: torch.dtype) -> bool:
    """Whether the training kernels take these widths on the card: the card's
    own counterpart of the JAX package's VMEM estimate (``_fused_ffn_ok``).
    Every launch of the forward and the backward must fit a block's shared
    memory; k is at most 63 in bf16 and 31 in f32 (where a backward block
    owns 32 - (k - 1) of the rows it recomputes)."""
    if dtype not in _MAX_K or C not in (32, 64, 128, 256) or F % 128 != 0:
        return False
    if not 1 <= k <= _MAX_K[dtype]:
        return False
    plans = ffn_plan(C, F, k, 1, 1, dtype, "train") + ffn_plan(C, F, k, 1, 1, dtype, "bwd")
    return all(p.smem_bytes <= SMEM_LIMIT for p in plans)


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
            f"ffn_ln_train kernels take f32 or bf16 z, C in (32, 64, 128, 256), "
            f"F % 128 == 0 and k <= {_MAX_K.get(z.dtype, 0)} within "
            f"{SMEM_LIMIT} bytes of shared memory; got {z.dtype}, C={C}, F={F}, k={k}")


def _kernel_layouts(p, dt: torch.dtype) -> Dict[str, torch.Tensor]:
    """The kernels' weight layouts of one training call, for the forward and
    the backward alike: the f32 taps, biases and LayerNorm vectors, and W1,
    W2f in the working dtype (bf16: the swizzled image; f32: as they are and
    transposed, as the CUDA-core backward reads them)."""
    wd, bd, w1, b1, w2f, b2f, g1, be1, g2, be2 = (t.detach() for t in p)
    lnp = torch.stack([g1.float(), be1.float(), g2.float(), be2.float(),
                       bd.float(), b2f.float()]).contiguous()
    out = dict(wd=wd.float().contiguous(), b1=b1.float().contiguous(), lnp=lnp)
    if dt == torch.bfloat16:
        out["img"] = _weight_image(w1, w2f)
    else:
        out.update(w1=w1.to(dt).contiguous(), w2f=w2f.to(dt).contiguous(),
                   w1T=w1.t().to(dt).contiguous(), w2fT=w2f.t().to(dt).contiguous())
    return out


def _train_fn():
    global _c_train
    if _c_train is None:
        _c_train = _lib_fn("ffn_ln", "lfs2_ffn_ln_train",
                           [_P] * 9 + [_I] * 5 + [_F, _U, _F, _I, _P])
    return _c_train


def _chain_fn():
    global _c_chain
    if _c_chain is None:
        _c_chain = _lib_fn("ffn_ln", "lfs2_ffn_ln_chain", [_P] * 11 + [_I] * 5 + [_F, _U, _F, _P])
    return _c_chain


def _bwd_fn():
    global _c_bwd
    if _c_bwd is None:
        _c_bwd = _lib_fn("ffn_ln_train_bwd", "lfs2_ffn_ln_train_bwd",
                         [_P] * 16 + [_I] * 5 + [_F, _U, _F, _P])
    return _c_bwd


def _bwd_bf16_fn():
    global _c_bwd_bf16
    if _c_bwd_bf16 is None:
        _c_bwd_bf16 = _lib_fn("ffn_ln_train_bwd", "lfs2_ffn_ln_train_bwd_bf16",
                              [_P] * 16 + [_I] * 5 + [_F, _U, _F, _P])
    return _c_bwd_bf16


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def ffn_ln_train_fwd(z: torch.Tensor, p, seed: torch.Tensor, rate: float,
                     eps: float = 1e-5, layouts: Optional[Dict[str, torch.Tensor]] = None
                     ) -> torch.Tensor:
    """Launch the training forward kernel (``csrc/ffn_ln.cu``, dropout on);
    CUDA tensors only. ``layouts`` (``_kernel_layouts``) are built here when
    not given. The result is not connected to autograd."""
    k, F = p[0].shape[0], p[2].shape[1]
    _check_train(z, k, F)
    w = _kernel_layouts(p, z.dtype) if layouts is None else layouts
    stream = kernel_stream(z, seed, *w.values())
    B, T, C = z.shape
    out = torch.empty_like(z)
    lib, fn = _train_fn()
    rc = fn(z.data_ptr(), out.data_ptr(), w["wd"].data_ptr(), _ptr(w.get("w1")),
            w["b1"].data_ptr(), _ptr(w.get("w2f")), w["lnp"].data_ptr(), _ptr(w.get("img")),
            seed.data_ptr(), B, T, C, F, k, eps, keep_threshold(rate), 1.0 / (1.0 - rate),
            build.DTYPE_CODES[z.dtype], stream)
    build.check(lib, rc, "ffn_ln_train")
    ffn_ln_train.launches += 1
    return out


def ffn_ln_train_bwd(dout: torch.Tensor, z: torch.Tensor, p, seed: torch.Tensor,
                     rate: float, eps: float = 1e-5,
                     layouts: Optional[Dict[str, torch.Tensor]] = None):
    """Launch the backward (CUDA tensors only): in bf16 the chain
    (``csrc/ffn_ln.cu``), then the dup and dt1 passes
    (``csrc/ffn_ln_train_bwd.cu``), through (B, T, C) scratch h0, dres, dff
    and dacc; in f32 the one recompute-based CUDA-core kernel. Returns
    ``dz`` and the f32 gradients of the ten entries of ``p``, in order."""
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
    if z.dtype == torch.bfloat16:
        h0, dff = torch.empty_like(z), torch.empty_like(z)
        dres = torch.empty(B, T, C, dtype=torch.float32, device=z.device)
        dacc = torch.empty_like(dres)
        lib, fn = _chain_fn()
        rc = fn(z.data_ptr(), dout.data_ptr(), w["wd"].data_ptr(), w["img"].data_ptr(),
                w["b1"].data_ptr(), w["lnp"].data_ptr(), seed.data_ptr(), h0.data_ptr(),
                dres.data_ptr(), dff.data_ptr(), dvec.data_ptr(), B, T, C, F, k, eps, thr, ik,
                stream)
        build.check(lib, rc, "ffn_ln_train_bwd (chain)")
        lib, fn = _bwd_bf16_fn()
        rc = fn(z.data_ptr(), dres.data_ptr(), h0.data_ptr(), dff.data_ptr(),
                w["wd"].data_ptr(), w["img"].data_ptr(), w["b1"].data_ptr(),
                w["lnp"].data_ptr(), seed.data_ptr(), dacc.data_ptr(), dz.data_ptr(),
                dwd.data_ptr(), dw1.data_ptr(), dw2f.data_ptr(), db1.data_ptr(),
                dvec.data_ptr(), B, T, C, F, k, eps, thr, ik, stream)
    else:
        lib, fn = _bwd_fn()
        rc = fn(z.data_ptr(), dout.data_ptr(), w["wd"].data_ptr(), w["w1"].data_ptr(),
                w["w1T"].data_ptr(), w["b1"].data_ptr(), w["w2f"].data_ptr(),
                w["w2fT"].data_ptr(), w["lnp"].data_ptr(), seed.data_ptr(),
                dz.data_ptr(), dwd.data_ptr(), dw1.data_ptr(), dw2f.data_ptr(),
                db1.data_ptr(), dvec.data_ptr(), B, T, C, F, k, eps, thr, ik, stream)
    build.check(lib, rc, "ffn_ln_train_bwd")
    ffn_ln_train_bwd.launches += 1
    dg1, dbe1, dg2, dbe2, dbd, db2f = dvec.view(6, C)
    return (dz, dwd.view(k, C), dbd, dw1.view(C, F), db1, dw2f.view(F, C),
            db2f, dg1, dbe1, dg2, dbe2)


def last_launches() -> Dict[str, object]:
    """The latest launches as the libraries recorded them when they were
    accepted, each ``{"grid", "smem_bytes", "rows"}``: under "ffn_ln" the
    forward library's latest (a forward, a serving call or the backward's
    chain), under "ffn_ln_train_bwd" the backward library's latest call
    (one launch in f32; the dup and dt1 passes in bf16). Zeros before the
    first."""
    def rec(r):
        return {"grid": (r[0], r[1], r[2]), "smem_bytes": r[3], "rows": r[4]}

    fwd = (ctypes.c_int * 5)()
    lib = build.load("ffn_ln")
    lib.lfs2_ffn_ln_last_launch.argtypes = [ctypes.POINTER(ctypes.c_int)]
    build.check(lib, lib.lfs2_ffn_ln_last_launch(fwd), "ffn_ln launch query")
    bwd = (ctypes.c_int * 10)()
    lib = build.load("ffn_ln_train_bwd")
    lib.lfs2_ffn_ln_train_bwd_last_launches.argtypes = [ctypes.POINTER(ctypes.c_int)]
    build.check(lib, lib.lfs2_ffn_ln_train_bwd_last_launches(bwd), "ffn_ln_train_bwd launch query")
    return {"ffn_ln": rec(fwd[:]),
            "ffn_ln_train_bwd": [rec(bwd[5 * i:5 * i + 5]) for i in range(2) if bwd[5 * i]]}


def planned_launch(launch: FFNLaunch) -> Dict[str, object]:
    """A plan entry in ``last_launches``' terms, to hold the two together."""
    return {"grid": launch.grid, "smem_bytes": launch.smem_bytes, "rows": launch.rows}


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

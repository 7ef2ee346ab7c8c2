"""The FFN half of a conformer FFT block: LN1 -> depthwise conv ->
pointwise up -> ReLU -> (grouped conv folded into) pointwise down ->
residual on the LN1 output -> LN2.

Counterpart of ``lightningfastspeech2_tpu/ops/pallas_ffn.py``:
``fused_ffn_ln`` (kernel ``_ffn_kernel``) as ``ffn_ln``, and
``fused_ffn_ln_train`` (kernels ``_ffn_train_kernel`` and
``_ffn_train_bwd_kernel``, joined by a custom VJP) as ``ffn_ln_train``.
``ffn_ln`` launches the CUDA kernel in ``csrc/ffn_ln.cu`` for a CUDA tensor
and runs ``ffn_ln_plain`` for a CPU tensor; ``ffn_ln_train`` launches the
same source's training forward and ``csrc/ffn_ln_train_bwd.cu`` through an
autograd Function, or runs ``ffn_ln_train_plain`` on the CPU. The rounding points follow the TPU
kernel: LN1 output, depthwise output and ReLU output are rounded to the
working dtype; the depthwise taps, both products and both LayerNorms
accumulate in f32.

Kernel weight layouts are prepared once, when weights load
(``prepare_ffn_weights``), not per call: the grouped k=1 conv and the
down-projection compose into one (F, C) matrix (``fold_grouped_into_down``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from lightningfastspeech2_tpu_torch.kernels import build
from lightningfastspeech2_tpu_torch.kernels.launch import kernel_stream
from lightningfastspeech2_tpu_torch.ops.depthwise import depthwise_conv1d
from lightningfastspeech2_tpu_torch.ops.layer_norm import layer_norm_fn

_c_fn = None


@dataclass
class FFNWeights:
    """Prepared weights of one FFN half, on the device it runs on."""

    wd: torch.Tensor    # (k, C) f32 depthwise taps
    w1: torch.Tensor    # (C, F) working dtype, pointwise up
    b1: torch.Tensor    # (F,) f32
    w2f: torch.Tensor   # (F, C) working dtype, grouped conv folded into down
    lnp: torch.Tensor   # (6, C) f32: g1, be1, g2, be2, bd, b2f
    eps: float = 1e-5

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
        lib = build.load("ffn_ln")
        fn = lib.lfs2_ffn_ln
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _c_fn = (lib, fn)
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
    stream = kernel_stream(z, w.wd, w.w1, w.b1, w.w2f, w.lnp)
    B, T, C = z.shape
    F = w.w1.shape[1]
    if z.dtype not in build.DTYPE_CODES or w.w1.dtype != z.dtype or w.w2f.dtype != z.dtype:
        raise ValueError(f"ffn_ln takes f32 or bf16 z with weights of the same "
                         f"dtype, got {z.dtype}, {w.w1.dtype}, {w.w2f.dtype}")
    if C not in (32, 64, 128, 256) or F % 128 != 0:
        raise ValueError(f"ffn_ln kernel takes C in (32, 64, 128, 256) and F % 128 "
                         f"== 0, got C={C}, F={F}")
    out = torch.empty_like(z)
    lib, fn = _fn()
    rc = fn(z.data_ptr(), out.data_ptr(), w.wd.data_ptr(), w.w1.data_ptr(),
            w.b1.data_ptr(), w.w2f.data_ptr(), w.lnp.data_ptr(), B, T, C, F,
            w.kernel_size, w.eps, build.DTYPE_CODES[z.dtype], stream)
    build.check(lib, rc, "ffn_ln")
    ffn_ln.launches += 1
    return out


ffn_ln.launches = 0


# ---------------------------------------------------------------------------
# training half: the same fusion plus two hashed dropouts, and a backward
# kernel that recomputes the forward per tile
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
# smem of one block of the backward kernel, and its tile rows (csrc/
# ffn_ln_train_bwd.cu): EP chain rows per block, F in chunks of FC
_BWD_EP = {torch.float32: 32, torch.bfloat16: 64}
_BWD_FC = 64
SMEM_LIMIT = 232448  # bytes of dynamic shared memory a block may use (H100)
_c_train = None
_c_bwd = None


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


def ffn_train_bwd_smem(C: int, F: int, k: int, dtype: torch.dtype) -> int:
    """Shared memory of one block of the backward kernel: the LN1 output
    over EP + k - 1 rows, the depthwise output and dff over EP rows (working
    dtype), dres over EP rows (f32), and one F chunk of the ReLU output
    (working dtype) and its gradient (f32)."""
    ep, s = _BWD_EP[dtype], torch.tensor([], dtype=dtype).element_size()
    return ((ep + k - 1) * C * s + 2 * ep * C * s + ep * C * 4
            + ep * _BWD_FC * (s + 4))


def ffn_train_fits(C: int, F: int, k: int, dtype: torch.dtype) -> bool:
    """Whether the training kernels take these widths on the card: the card's
    own counterpart of the JAX package's VMEM estimate (``_fused_ffn_ok``).
    Each backward block owns EP chain rows of which EP - (k - 1) are its
    own, and its buffers must fit the block's shared memory."""
    return (dtype in _BWD_EP and C in (32, 64, 128, 256) and F % 128 == 0
            and 1 <= k <= _BWD_EP[dtype] - 1
            and ffn_train_bwd_smem(C, F, k, dtype) <= SMEM_LIMIT)


def _check_train(z: torch.Tensor, k: int, F: int) -> None:
    B, T, C = z.shape
    if not ffn_train_fits(C, F, k, z.dtype):
        raise ValueError(
            f"ffn_ln_train kernels take f32 or bf16 z, C in (32, 64, 128, 256), "
            f"F % 128 == 0 and k <= {_BWD_EP.get(z.dtype, 0) - 1} within "
            f"{SMEM_LIMIT} bytes of shared memory; got {z.dtype}, C={C}, F={F}, k={k}")


def _kernel_layouts(p, dt: torch.dtype, transposed: bool):
    wd, bd, w1, b1, w2f, b2f, g1, be1, g2, be2 = (t.detach() for t in p)
    lnp = torch.stack([g1.float(), be1.float(), g2.float(), be2.float(),
                       bd.float(), b2f.float()]).contiguous()
    out = dict(wd=wd.float().contiguous(), w1=w1.to(dt).contiguous(),
               b1=b1.float().contiguous(), w2f=w2f.to(dt).contiguous(), lnp=lnp)
    if transposed:
        out["w1T"] = w1.t().to(dt).contiguous()
        out["w2fT"] = w2f.t().to(dt).contiguous()
    return out


def _train_fn():
    global _c_train
    if _c_train is None:
        lib = build.load("ffn_ln")
        fn = lib.lfs2_ffn_ln_train
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float,
                       ctypes.c_uint32, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _c_train = (lib, fn)
    return _c_train


def _bwd_fn():
    global _c_bwd
    if _c_bwd is None:
        lib = build.load("ffn_ln_train_bwd")
        fn = lib.lfs2_ffn_ln_train_bwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p, p, p, p, p,
                       i, i, i, i, i, ctypes.c_float, ctypes.c_uint32,
                       ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _c_bwd = (lib, fn)
    return _c_bwd


def ffn_ln_train_fwd(z: torch.Tensor, p, seed: torch.Tensor, rate: float,
                     eps: float = 1e-5) -> torch.Tensor:
    """Launch the training forward kernel (``csrc/ffn_ln.cu``, dropout on);
    CUDA tensors only. The result is not connected to autograd."""
    k, F = p[0].shape[0], p[2].shape[1]
    _check_train(z, k, F)
    w = _kernel_layouts(p, z.dtype, transposed=False)
    stream = kernel_stream(z, seed, *w.values())
    B, T, C = z.shape
    out = torch.empty_like(z)
    lib, fn = _train_fn()
    rc = fn(z.data_ptr(), out.data_ptr(), w["wd"].data_ptr(), w["w1"].data_ptr(),
            w["b1"].data_ptr(), w["w2f"].data_ptr(), w["lnp"].data_ptr(),
            seed.data_ptr(), B, T, C, F, k, eps, keep_threshold(rate),
            1.0 / (1.0 - rate), build.DTYPE_CODES[z.dtype], stream)
    build.check(lib, rc, "ffn_ln_train")
    ffn_ln_train.launches += 1
    return out


def ffn_ln_train_bwd(dout: torch.Tensor, z: torch.Tensor, p, seed: torch.Tensor,
                     rate: float, eps: float = 1e-5):
    """Launch the recompute-based backward kernel (``csrc/ffn_ln_train_bwd.cu``);
    CUDA tensors only. Returns ``dz`` and the f32 gradients of the ten
    entries of ``p``, in order."""
    k, F = p[0].shape[0], p[2].shape[1]
    _check_train(z, k, F)
    w = _kernel_layouts(p, z.dtype, transposed=True)
    dout = dout.to(z.dtype).contiguous()
    stream = kernel_stream(z, dout, seed, *w.values())
    B, T, C = z.shape
    dz = torch.empty_like(z)
    # one zeroed f32 buffer for every weight gradient: the blocks add their
    # tile's contribution with atomics
    sizes = (k * C, C * F, F * C, F, 6 * C)
    grads = torch.zeros(sum(sizes), dtype=torch.float32, device=z.device)
    dwd, dw1, dw2f, db1, dvec = torch.split(grads, sizes)
    lib, fn = _bwd_fn()
    rc = fn(z.data_ptr(), dout.data_ptr(), w["wd"].data_ptr(), w["w1"].data_ptr(),
            w["w1T"].data_ptr(), w["b1"].data_ptr(), w["w2f"].data_ptr(),
            w["w2fT"].data_ptr(), w["lnp"].data_ptr(), seed.data_ptr(),
            dz.data_ptr(), dwd.data_ptr(), dw1.data_ptr(), dw2f.data_ptr(),
            db1.data_ptr(), dvec.data_ptr(), B, T, C, F, k, eps,
            keep_threshold(rate), 1.0 / (1.0 - rate), build.DTYPE_CODES[z.dtype], stream)
    build.check(lib, rc, "ffn_ln_train_bwd")
    ffn_ln_train_bwd.launches += 1
    dg1, dbe1, dg2, dbe2, dbd, db2f = dvec.view(6, C)
    return (dz, dwd.view(k, C), dbd, dw1.view(C, F), db1, dw2f.view(F, C),
            db2f, dg1, dbe1, dg2, dbe2)


class _FFNLnTrain(torch.autograd.Function):
    """Forward and backward kernels joined like the JAX package's custom VJP:
    the forward saves only its inputs; the backward recomputes per tile."""

    @staticmethod
    def forward(ctx, z, seed, rate, eps, *p):
        ctx.save_for_backward(z, seed, *p)
        ctx.rate, ctx.eps = rate, eps
        return ffn_ln_train_fwd(z, p, seed, rate, eps)

    @staticmethod
    def backward(ctx, dout):
        z, seed, *p = ctx.saved_tensors
        dz, *dp = ffn_ln_train_bwd(dout, z, p, seed, ctx.rate, ctx.eps)
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

"""The FFN half of a conformer FFT block: LN1 -> depthwise conv ->
pointwise up -> ReLU -> (grouped conv folded into) pointwise down ->
residual on the LN1 output -> LN2.

Counterpart of ``lightningfastspeech2_tpu/ops/pallas_ffn.py``
(``fused_ffn_ln`` and its kernel ``_ffn_kernel``). ``ffn_ln`` launches the
CUDA kernel in ``csrc/ffn_ln.cu`` for a CUDA tensor and runs
``ffn_ln_plain`` for a CPU tensor. The rounding points follow the TPU
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

from lightningfastspeech2_tpu_torch.core.device import check_kernel_inputs
from lightningfastspeech2_tpu_torch.kernels import build
from lightningfastspeech2_tpu_torch.ops.depthwise import depthwise_conv1d
from lightningfastspeech2_tpu_torch.ops.layer_norm import layer_norm_fn

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
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
            b1=conv1_point.bias.float().contiguous(),
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
    raises on anything else."""
    if z.device.type == "cpu":
        return ffn_ln_plain(z, w)
    check_kernel_inputs(z, w.wd, w.w1, w.b1, w.w2f, w.lnp)
    B, T, C = z.shape
    F = w.w1.shape[1]
    if z.dtype not in _DTYPES or w.w1.dtype != z.dtype or w.w2f.dtype != z.dtype:
        raise ValueError(f"ffn_ln takes f32 or bf16 z with weights of the same "
                         f"dtype, got {z.dtype}, {w.w1.dtype}, {w.w2f.dtype}")
    if C not in (32, 64, 128, 256) or F % 128 != 0:
        raise ValueError(f"ffn_ln kernel takes C in (32, 64, 128, 256) and F % 128 "
                         f"== 0, got C={C}, F={F}")
    out = torch.empty_like(z)
    lib, fn = _fn()
    rc = fn(z.data_ptr(), out.data_ptr(), w.wd.data_ptr(), w.w1.data_ptr(),
            w.b1.data_ptr(), w.w2f.data_ptr(), w.lnp.data_ptr(), B, T, C, F,
            w.kernel_size, w.eps, _DTYPES[z.dtype],
            torch.cuda.current_stream(z.device).cuda_stream)
    build.check(lib, rc, "ffn_ln")
    ffn_ln.launches += 1
    return out


ffn_ln.launches = 0

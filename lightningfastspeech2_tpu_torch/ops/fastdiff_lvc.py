"""FastDiff's time-aware LVC chain: all layers of one upsample stage.

Counterpart of ``lightningfastspeech2_tpu/ops/pallas_fastdiff.py``
(``fused_lvc_stack`` / ``_stack_kernel``). Per layer i of a stage with hop
``hop`` (the samples one mel frame covers at that stage):

    x += audio_down; y = leaky(x, 0.2); y = dilated_conv_i(y)  (k=3, d=3^i)
    y = leaky(y, 0.2); g = LVC(y, frame kernels and biases of layer i)
    x += sigmoid(g[:C]) * tanh(g[C:])          (or the Padé gate)

For a CUDA tensor ``lvc_stack`` launches the kernel in
``csrc/lvc_stack.cu``; for a CPU tensor it runs ``lvc_stack_plain``. Both
round where the TPU kernel rounds: x and audio_down, the leaky input of the
conv and the LVC input in the working dtype; conv and LVC products summed
in f32 with f32 biases; the gate in f32, rounded to the working dtype
before the residual add.

The elementwise pieces (``fast_tanh``, ``gated_activation``) and
``location_variable_convolution`` live here too; ``vocoder.fastdiff``
takes them from this module.

Which stages take the kernel is the JAX package's rule
(``vocoder/fastdiff.py`` ``eps_apply_fused``), kept as it stands:
``routes_to_kernel``.
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from lightningfastspeech2_tpu_torch.kernels import build
from lightningfastspeech2_tpu_torch.kernels.launch import kernel_stream

LRELU_SLOPE = 0.2
# the JAX path's frame tile for a stage whose hop is below the reach when
# LFS2_FUSED_STAGE1 is set (max(tile, 16), and its dtype tiles are <= 16)
HALO_TILE_FRAMES = 16
# output rows per block of the kernel, largest first: the largest that
# still gives at least one block per SM of the H100's 132
_TILES = (256, 128, 64)
_SMS = 132
_c_fn = None


def fast_tanh(x: torch.Tensor) -> torch.Tensor:
    """Clamped Padé(7,6) tanh: max abs error 9.6e-5 over the whole line."""
    t = torch.clamp(x, -4.97, 4.97)
    t2 = t * t
    num = t * (135135.0 + t2 * (17325.0 + t2 * (378.0 + t2)))
    den = 135135.0 + t2 * (62370.0 + t2 * (3150.0 + t2 * 28.0))
    return torch.clamp(num / den, -1.0, 1.0)


def fast_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """sigmoid(x) = 0.5 (1 + tanh(x/2)) via fast_tanh; max err ~5e-5."""
    return 0.5 * (fast_tanh(0.5 * x) + 1.0)


def gated_activation(y: torch.Tensor, channels: int, fast: bool) -> torch.Tensor:
    """sigmoid(y[..., :C]) * tanh(y[..., C:]), or the rational
    approximations with ``fast`` (the config's ``fast_gating``)."""
    a, b = y[..., :channels], y[..., channels:]
    if fast:
        return fast_sigmoid(a) * fast_tanh(b)
    return torch.sigmoid(a) * torch.tanh(b)


def location_variable_convolution(x: torch.Tensor, kernels: torch.Tensor,
                                  bias: torch.Tensor, hop: int) -> torch.Tensor:
    """Per-frame convolution with frame-local kernels: x (B, L, Cin),
    kernels (B, nL, Cin, Cout, ks), bias (B, nL, Cout) -> (B, L, Cout). Tap
    k reads the rows [k, k + L) of the zero-padded signal, reshaped to
    (nL, hop): three shifted batched products, no gather."""
    B, L, Cin = x.shape
    _, nL, _, Cout, ks = kernels.shape
    if L != nL * hop:
        raise ValueError(f"{L} != {nL}*{hop}")
    pad = (ks - 1) // 2
    xp = F.pad(x, (0, 0, pad, pad))
    out = None
    for k in range(ks):
        seg = xp[:, k:k + L].reshape(B, nL, hop, Cin)
        contrib = torch.einsum("blti,blio->blto", seg, kernels[..., k])
        out = contrib if out is None else out + contrib
    out = out + bias[:, :, None, :]
    return out.reshape(B, L, Cout)


def lvc_reach(layers: int) -> int:
    """Samples the chain reaches on each side: each layer's dilated conv
    (3^i) and its LVC (1); 44 for four layers."""
    return sum(3 ** i + 1 for i in range(layers))


def pick_halo_frames(reach: int, hop: int, frames: int):
    """Smallest divisor of ``frames`` whose rows cover ``reach``, or None
    (the JAX package's ``pick_halo_frames``, used here only for routing)."""
    for h in range(1, frames + 1):
        if frames % h == 0 and h * hop >= reach:
            return h
    return None


def stage1_opt_in() -> bool:
    """``LFS2_FUSED_STAGE1``, read at each call: sends a stage whose hop is
    below the reach to the kernel too, where the JAX path would fuse it."""
    return os.environ.get("LFS2_FUSED_STAGE1", "0").lower() in ("1", "true", "on")


def routes_to_kernel(hop: int, n_frames: int, layers: int) -> bool:
    """Whether a stage's chain goes to ``lvc_stack``: the JAX gate of
    ``eps_apply_fused``, ``hop >= reach``, or the opt-in with a halo of
    whole frames inside a tile of min(16, n_frames) frames."""
    reach = lvc_reach(layers)
    if hop >= reach:
        return True
    return stage1_opt_in() and pick_halo_frames(
        reach, hop, min(HALO_TILE_FRAMES, n_frames)) is not None


def _conv_f32(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor, d: int) -> torch.Tensor:
    """Same-padded dilated conv of y (B, L, C) with taps w (3, Cin, Cout),
    in f32."""
    wt = w.float().permute(2, 1, 0)
    return F.conv1d(y.float().transpose(1, 2), wt, b.float(), padding=d,
                    dilation=d).transpose(1, 2)


def lvc_stack_plain(x, audio_down, kernels, biases, conv_w, conv_b, hop: int,
                    fast_gating: bool = False) -> torch.Tensor:
    """The chain in plain PyTorch, rounding where the kernel rounds.

    x, audio_down (B, L, C) in the working dtype; kernels (B, nL, layers,
    C, 2C, 3) (the kernel predictor's layout); biases (B, nL, layers, 2C);
    conv_w (layers, 3, C, C) taps (k, in, out); conv_b (layers, C)."""
    dt = x.dtype
    C = x.shape[-1]
    ad = audio_down.to(dt)
    for i in range(kernels.shape[2]):
        d = 3 ** i
        x = x + ad
        y = torch.maximum(x, x * LRELU_SLOPE)
        y = _conv_f32(y, conv_w[i].to(dt), conv_b[i], d)
        y = torch.maximum(y, y * LRELU_SLOPE).to(dt)
        g = location_variable_convolution(
            y.float(), kernels[:, :, i].to(dt).float(), biases[:, :, i].float(), hop)
        x = x + gated_activation(g, C, fast_gating).to(dt)
    return x


# lvc_stack in bf16 against lvc_stack_plain, which rounds at the same
# places: a value differs only where a sum taken in another order rounds
# the other way, and that flip carries down the residual chain
# (chip_smoke.py prints both measures for each shape it checks)
BF16_MAX_ULPS = 3
BF16_MAX_UNEQUAL = 0.02


def bf16_chain_error(out, ref, x, audio_down, layers: int):
    """How far a bf16 chain ``out`` lies from ``ref`` (both from x0 = ``x``
    and ``audio_down``): the largest |out - ref| in bf16 ulps of a bound on
    every |x| the chain holds at that value, |x0| + layers (|audio_down| +
    1) (each gate lies in (-1, 1)), and the share of values that differ.
    They agree within ``BF16_MAX_ULPS`` and ``BF16_MAX_UNEQUAL``. A value's
    own |ref| is no bound: x cancels to near 0 where it held a large value."""
    s = x.float().abs() + layers * (audio_down.float().abs() + 1.0)
    diff = (out.float() - ref.float()).abs()
    ulps = diff / torch.exp2(torch.floor(torch.log2(s)) - 7)
    return ulps.max().item(), (diff > 0).float().mean().item()


def _fn():
    global _c_fn
    if _c_fn is None:
        lib = build.load("lvc_stack")
        fn = lib.lfs2_lvc_stack
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 7 + [i] * 7 + [p]
        fn.restype = ctypes.c_int
        _c_fn = (lib, fn)
    return _c_fn


def kernel_tile(batch: int, length: int) -> int:
    """Output rows per block: the largest of ``_TILES`` that still gives
    every SM a block (the smallest otherwise)."""
    for tile in _TILES:
        if batch * -(-length // tile) >= _SMS:
            return tile
    return _TILES[-1]


def lvc_stack(x, audio_down, kernels, biases, conv_w, conv_b, hop: int,
              fast_gating: bool = False) -> torch.Tensor:
    """The whole chain of one stage (see ``lvc_stack_plain`` for the
    arguments): the kernel for CUDA tensors, the plain version on the CPU."""
    if x.device.type == "cpu":
        return lvc_stack_plain(x, audio_down, kernels, biases, conv_w, conv_b, hop,
                               fast_gating)
    B, L, C = x.shape
    layers = kernels.shape[2]
    dt = x.dtype
    if dt not in build.DTYPE_CODES or C != 32:
        raise ValueError(f"lvc_stack kernel takes f32 or bf16 x with C=32, got {dt}, C={C}")
    if (audio_down.shape != x.shape or kernels.shape != (B, L // hop, layers, C, 2 * C, 3)
            or L % hop or biases.shape != (B, L // hop, layers, 2 * C)
            or conv_w.shape != (layers, 3, C, C) or conv_b.shape != (layers, C)):
        raise ValueError(
            f"lvc_stack: shapes x {tuple(x.shape)}, audio_down {tuple(audio_down.shape)}, "
            f"kernels {tuple(kernels.shape)}, biases {tuple(biases.shape)}, "
            f"conv_w {tuple(conv_w.shape)}, conv_b {tuple(conv_b.shape)} at hop {hop}")
    for name, t in (("audio_down", audio_down), ("kernels", kernels), ("conv_w", conv_w)):
        if t.dtype != dt:
            raise ValueError(f"lvc_stack: {name} is {t.dtype}, x is {dt}")
    biases, conv_b = biases.float().contiguous(), conv_b.float().contiguous()
    stream = kernel_stream(x, audio_down, kernels, biases, conv_w, conv_b)
    out = torch.empty_like(x)
    lib, fn = _fn()
    rc = fn(x.data_ptr(), audio_down.data_ptr(), kernels.data_ptr(), biases.data_ptr(),
            conv_w.data_ptr(), conv_b.data_ptr(), out.data_ptr(), B, L, hop, layers,
            kernel_tile(B, L), int(fast_gating), build.DTYPE_CODES[dt], stream)
    build.check(lib, rc, "lvc_stack")
    lvc_stack.launches += 1
    return out


lvc_stack.launches = 0

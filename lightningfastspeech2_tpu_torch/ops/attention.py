"""Flash attention for the FFT-block self-attention in training.

Counterpart of ``lightningfastspeech2_tpu/ops/pallas_attention.py``
(``flash_attention``: ``_fwd_kernel`` and ``_bwd_kernel`` joined by a custom
VJP). ``flash_attention`` runs ``flash_attention_plain`` for CPU tensors and,
for CUDA tensors, the forward and backward kernels of
``csrc/flash_attention.cu`` through an autograd Function.

Semantics as there: scores scaled by 1/sqrt(d), padded KEYS set to -1e30
(queries are not masked), softmax, attention-probability dropout from a
position hash (``attention_keep_mask``, bit for bit ``_dropout_keep``) with
kept probabilities scaled by 1/(1 - rate), then P.V.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from lightningfastspeech2_tpu_torch.core.device import check_kernel_inputs
from lightningfastspeech2_tpu_torch.kernels import build
from lightningfastspeech2_tpu_torch.ops.ffn import (
    _DTYPES,
    _M32,
    _fmix,
    _mul32,
    _rnd,
    keep_threshold,
)

NEG_INF = -1e30
HEAD_DIM = 128  # the kernels' only head dim (every preset's)
_c_fns = None


def attn_keep_hash(rows: torch.Tensor, cols: torch.Tensor, seed_bh: torch.Tensor,
                   rate: float) -> torch.Tensor:
    """``_dropout_keep`` of ``ops/pallas_attention.py`` bit for bit, for
    global query rows ``rows`` (R,) and key columns ``cols`` (K,):
    ``(r * 2654435761) ^ (c * 1013904223) + seed_bh``, then the finalizer.
    ``seed_bh`` is an int64 tensor of uint32 values that broadcasts against
    (R, K)."""
    x = (_mul32(rows.to(torch.int64) & _M32, 2654435761)[:, None]
         ^ _mul32(cols.to(torch.int64) & _M32, 1013904223)[None, :])
    return _fmix((x + seed_bh) & _M32) >= keep_threshold(rate)


def attention_keep_mask(B: int, H: int, T: int, rate: float, seed: torch.Tensor,
                        device=None) -> torch.Tensor:
    """(B, H, T, T) keep mask of the attention dropout, with
    ``seed_bh = seed + b * H + h`` (an int32 sum read as uint32)."""
    device = seed.device if device is None else device
    i = torch.arange(T, dtype=torch.int64, device=device)
    bh = (torch.arange(B, dtype=torch.int64, device=device)[:, None] * H
          + torch.arange(H, dtype=torch.int64, device=device)[None, :])
    sbh = (seed.to(device=device, dtype=torch.int64).reshape(()) + bh) & _M32
    return attn_keep_hash(i, i, sbh[:, :, None, None], rate)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor], rate: float,
                          seed: torch.Tensor) -> torch.Tensor:
    """Plain, autograd-differentiable version: einsum, key mask at -1e30,
    softmax in f32, hashed dropout and /(1 - rate), probabilities rounded to
    v's dtype before P.V (f32 accumulation)."""
    B, H, T, d = q.shape
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if mask is not None:
        s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if rate > 0.0:
        keep = attention_keep_mask(B, H, T, rate, seed, q.device)
        p = torch.where(keep, p, 0.0) / (1.0 - rate)
    return (_rnd(p, v.dtype) @ v.float()).to(q.dtype)


def _fns():
    global _c_fns
    if _c_fns is None:
        lib = build.load("flash_attention")
        p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
        fwd = lib.lfs2_flash_attention_fwd
        fwd.argtypes = [p] * 7 + [i, i, i, i, f, u, f, i, p]
        fwd.restype = ctypes.c_int
        bwd = lib.lfs2_flash_attention_bwd
        bwd.argtypes = [p] * 12 + [i, i, i, i, f, u, f, i, p]
        bwd.restype = ctypes.c_int
        _c_fns = (lib, fwd, bwd)
    return _c_fns


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    B, H, T, d = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes f32 or bf16 q, k, v of one dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if d != HEAD_DIM or T % 64 != 0 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention kernels take (B, H, T, {HEAD_DIM}) with T % 64 "
                         f"== 0, got q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_fwd(q, k, v, mask_i32, seed, rate):
    """Launch the forward kernel; returns (o, lse (B, H, T) f32). CUDA only."""
    _check(q, k, v)
    check_kernel_inputs(q, k, v, mask_i32, seed)
    B, H, T, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    lib, fn, _ = _fns()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_i32.data_ptr(),
            seed.data_ptr(), o.data_ptr(), lse.data_ptr(), B, H, T, d,
            1.0 / math.sqrt(d), keep_threshold(rate), 1.0 / (1.0 - rate),
            _DTYPES[q.dtype], _stream(q))
    build.check(lib, rc, "flash_attention")
    flash_attention.launches += 1
    return o, lse


def flash_attention_bwd(do, q, k, v, mask_i32, seed, o, lse, rate):
    """Launch the backward (the dQ pass, then the K-major dK/dV pass);
    returns (dq, dk, dv). CUDA only."""
    _check(q, k, v)
    do = do.to(q.dtype).contiguous()
    check_kernel_inputs(q, k, v, mask_i32, seed, o, lse, do)
    B, H, T, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dsum = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    lib, _, fn = _fns()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_i32.data_ptr(),
            seed.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dsum.data_ptr(),
            B, H, T, d, 1.0 / math.sqrt(d), keep_threshold(rate), 1.0 / (1.0 - rate),
            _DTYPES[q.dtype], _stream(q))
    build.check(lib, rc, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask_i32, seed, rate):
        o, lse = flash_attention_fwd(q, k, v, mask_i32, seed, rate)
        ctx.save_for_backward(q, k, v, mask_i32, seed, o, lse)
        ctx.rate = rate
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask_i32, seed, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(do, q, k, v, mask_i32, seed, o, lse, ctx.rate)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, rate: float = 0.0,
                    seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v for (B, H, T, d) q/k/v, ``mask`` (B, T)
    True = valid key, dropout ``rate`` on the probabilities keyed by
    ``seed``, a (1,) int32 tensor on q's device (0 when None).

    CPU tensors take ``flash_attention_plain``. CUDA tensors run the kernels
    (d = 128, T % 64 == 0, f32 or bf16) and raise on anything else."""
    B, H, T, _ = q.shape
    if seed is None:
        seed = torch.zeros(1, dtype=torch.int32, device=q.device)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask, rate, seed)
    if mask is None:
        mask = torch.ones(B, T, dtype=torch.bool, device=q.device)
    return _FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                 mask.to(torch.int32).contiguous(), seed, float(rate))


flash_attention.launches = 0
flash_attention_bwd.launches = 0

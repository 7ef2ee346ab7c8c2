"""Flash attention for the FFT-block self-attention in training.

Counterpart of ``lightningfastspeech2_tpu/ops/pallas_attention.py``
(``flash_attention``: ``_fwd_kernel`` and ``_bwd_kernel`` joined by a custom
VJP). ``flash_attention`` runs ``flash_attention_plain`` for CPU tensors and,
for CUDA tensors, forward and backward kernels through an autograd Function,
the route chosen by dtype and head dim (``kernel_route``): at head dim 128
or 256, bf16 takes the Hopper tensor-core kernels of
``csrc/flash_attention_sm90.cu`` (wgmma fed by TMA), f32 the split-TF32
``mma.sync`` kernels of ``csrc/flash_attention.cu`` (tensor cores at f32
accuracy); every larger multiple of 128 takes the CUDA-core kernels of
``csrc/flash_attention_wide.cu`` in both dtypes.

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

from lightningfastspeech2_tpu_torch.kernels import build
from lightningfastspeech2_tpu_torch.kernels.launch import kernel_stream
from lightningfastspeech2_tpu_torch.ops.ffn import (
    _M32,
    _fmix,
    _mul32,
    _rnd,
    keep_threshold,
)

NEG_INF = -1e30
TENSOR_CORE_DIMS = (128, 256)  # head dims of the tensor-core routes; larger ones take WIDE_ROUTES


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


# the route of each dtype at head dims 128 and 256 (bf16 through wgmma, f32
# through split-TF32 mma.sync) and past 256 (CUDA cores); a route's launchers
# are lfs2_<route>_fwd / _bwd, all with one signature, in the library
# csrc/<LIBRARY[route]>.cu
ROUTES = {torch.bfloat16: "flash_attention_sm90", torch.float32: "flash_attention"}
WIDE_ROUTES = {torch.bfloat16: "flash_attention_wide_bf16", torch.float32: "flash_attention_wide_f32"}
LIBRARY = {**{r: r for r in ROUTES.values()},
           **dict.fromkeys(WIDE_ROUTES.values(), "flash_attention_wide")}
_c_fns = {}


def _fns(route: str):
    """The route's forward and backward launchers."""
    if route not in _c_fns:
        lib = build.load(LIBRARY[route])
        p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
        fwd = getattr(lib, f"lfs2_{route}_fwd")
        fwd.argtypes = [p] * 8 + [i, i, i, i, f, u, f, p]
        fwd.restype = ctypes.c_int
        bwd = getattr(lib, f"lfs2_{route}_bwd")
        bwd.argtypes = [p] * 12 + [i, i, i, i, f, u, f, p]
        bwd.restype = ctypes.c_int
        _c_fns[route] = (lib, fwd, bwd)
    return _c_fns[route]


def kernel_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The route the kernels of these inputs take (their library is
    ``csrc/<LIBRARY[route]>.cu``), after the kernels' rules on dtype and
    shape; raises on inputs no kernel takes. Needs no card: the tests call
    it on CPU tensors."""
    if q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernels take f32 or bf16 q, k, v of one dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape or q.shape[-1] % 128 != 0:
        raise ValueError(f"flash_attention kernels take q, k, v of one shape (B, H, T, d) "
                         f"with d a multiple of 128, got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    T = q.shape[2]
    if T < 128 or T % 128 != 0:
        raise ValueError(f"flash_attention kernels take T a multiple of 128 (their 128-row "
                         f"tiles), got T = {T}")
    return (ROUTES if q.shape[-1] in TENSOR_CORE_DIMS else WIDE_ROUTES)[q.dtype]


def _check_aligned(*ts: torch.Tensor) -> None:
    # the tensor maps and vector loads take 16-byte aligned rows
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("flash_attention kernels take 16-byte aligned tensors")


def _count(fn, route: str, head_dim: int) -> None:
    fn.launches += 1
    fn.by_route[route] += 1
    fn.by_head_dim[(route, head_dim)] = fn.by_head_dim.get((route, head_dim), 0) + 1


def flash_attention_fwd(q, k, v, mask_i32, seed, rate):
    """Launch the forward kernel; returns (o, lse (B, H, T) f32, o32), o32
    being o in f32 before its rounding (o itself for f32 inputs): the
    backward forms D = rowsum(dO o O) from it, which cancels exactly against
    dP where one key takes all the weight. CUDA only."""
    route = kernel_route(q, k, v)
    stream = kernel_stream(q, k, v, mask_i32, seed)
    _check_aligned(q, k, v, mask_i32)
    B, H, T, d = q.shape
    o = torch.empty_like(q)
    o32 = o if q.dtype == torch.float32 else torch.empty_like(q, dtype=torch.float32)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    lib, fn, _ = _fns(route)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_i32.data_ptr(),
            seed.data_ptr(), o.data_ptr(), lse.data_ptr(), o32.data_ptr(), B, H, T, d,
            1.0 / math.sqrt(d), keep_threshold(rate), 1.0 / (1.0 - rate), stream)
    build.check(lib, rc, "flash_attention")
    _count(flash_attention, route, d)
    return o, lse, o32


def flash_attention_bwd(do, q, k, v, mask_i32, seed, o32, lse, rate):
    """Launch the backward (the dQ pass, then the K-major dK/dV pass) from
    the forward's o32 and lse; returns (dq, dk, dv). CUDA only."""
    route = kernel_route(q, k, v)
    do = do.to(q.dtype).contiguous()
    stream = kernel_stream(q, k, v, mask_i32, seed, o32, lse, do)
    if o32.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd takes the forward's f32 output, got {o32.dtype}")
    _check_aligned(q, k, v, mask_i32, o32, lse, do)
    B, H, T, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dsum = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    lib, _, fn = _fns(route)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_i32.data_ptr(),
            seed.data_ptr(), o32.data_ptr(), lse.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dsum.data_ptr(),
            B, H, T, d, 1.0 / math.sqrt(d), keep_threshold(rate), 1.0 / (1.0 - rate), stream)
    build.check(lib, rc, "flash_attention_bwd")
    _count(flash_attention_bwd, route, d)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask_i32, seed, rate):
        o, lse, o32 = flash_attention_fwd(q, k, v, mask_i32, seed, rate)
        ctx.save_for_backward(q, k, v, mask_i32, seed, o32, lse)
        ctx.rate = rate
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask_i32, seed, o32, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(do, q, k, v, mask_i32, seed, o32, lse, ctx.rate)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, rate: float = 0.0,
                    seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v for (B, H, T, d) q/k/v, ``mask`` (B, T)
    True = valid key, dropout ``rate`` on the probabilities keyed by
    ``seed``, a (1,) int32 tensor on q's device (0 when None).

    CPU tensors take ``flash_attention_plain``. CUDA tensors run the kernels
    (d a multiple of 128, T % 128 == 0; at d = 128 and 256 bf16 through
    wgmma, f32 through split-TF32 mma.sync, both on the tensor cores; past
    256 the CUDA-core route) and raise on anything else."""
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
# launches by route and by (route, head dim), set to 0 with the counts:
# which route a run took, and at which head dims
flash_attention.by_route = dict.fromkeys(LIBRARY, 0)
flash_attention_bwd.by_route = dict.fromkeys(LIBRARY, 0)
flash_attention.by_head_dim = {}
flash_attention_bwd.by_head_dim = {}

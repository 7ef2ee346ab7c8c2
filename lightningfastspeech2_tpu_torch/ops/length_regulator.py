"""Length regulation: expand phone-level states to frame level by duration.

Counterpart of ``lightningfastspeech2_tpu/ops/length_regulator.py`` and
``ops/pallas_length_regulator.py``. With a static output length T, frame t
of item b copies phone #{ends <= t}, where ``ends`` is the running sum of
the durations; frames past the item's total are zero and the returned mask
is True at valid frames.

``regulate`` is the gather (``regulate_plain``), the JAX package's default.
The JAX package's own opt-in, ``LFS2_PALLAS_LR`` set to ``1``, ``true`` or
``on`` (read at each call), routes a 3-D ``x`` on a CUDA tensor with
``max_frames % 256 == 0`` to ``regulate_kernel``: the expand and
segment-sum kernels of ``csrc/length_regulator.cu`` (``regulate_pallas``'s
``_expand_kernel`` and ``_grad_kernel``) through an autograd Function. The
switch turns a kernel on, never off.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import torch

from lightningfastspeech2_tpu_torch.kernels import build
from lightningfastspeech2_tpu_torch.kernels.launch import kernel_stream

T_TILE = 256  # the JAX kernel's frame tile; its gate needs max_frames % T_TILE == 0
_c_fns = None


def kernel_opted_in() -> bool:
    """The JAX package's opt-in for the regulator kernel, read at call time."""
    return os.environ.get("LFS2_PALLAS_LR", "0").lower() in ("1", "true", "on")


def regulate(x: torch.Tensor, durations: torch.Tensor,
             max_frames: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, P, H) or (B, P), durations (B, P) -> (frames (B, T, ...),
    frame_mask (B, T)) with T = ``max_frames``: the gather, or the kernels
    where the JAX package's opt-in applies."""
    if (kernel_opted_in() and x.device.type == "cuda" and x.dim() == 3
            and max_frames % T_TILE == 0):
        return regulate_kernel(x, durations, max_frames)
    return regulate_plain(x, durations, max_frames)


def regulate_plain(x: torch.Tensor, durations: torch.Tensor,
                   max_frames: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gather, differentiable by autograd (the JAX default path)."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[..., None]
    B = x.shape[0]
    ends = torch.cumsum(durations.clamp(min=0).to(torch.int64), dim=-1)
    t = torch.arange(max_frames, device=x.device, dtype=torch.int64)
    # phone owning frame t: the number of ends <= t
    idx = torch.searchsorted(ends, t.expand(B, max_frames).contiguous(),
                             right=True)
    total = ends[:, -1]
    mask = t[None, :] < torch.clamp(total, max=max_frames)[:, None]
    idx = torch.clamp(idx, max=x.shape[1] - 1)
    frames = torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[-1]))
    frames = torch.where(mask[:, :, None], frames, torch.zeros((), dtype=x.dtype,
                                                               device=x.device))
    if squeeze:
        frames = frames[..., 0]
    return frames, mask


def _fns():
    global _c_fns
    if _c_fns is None:
        lib = build.load("length_regulator")
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.lfs2_regulate_fwd, lib.lfs2_regulate_bwd):
            fn.argtypes = [p, p, p, i, i, i, i, i, p]
            fn.restype = ctypes.c_int
        _c_fns = (lib, lib.lfs2_regulate_fwd, lib.lfs2_regulate_bwd)
    return _c_fns


def _check(t: torch.Tensor, ends: torch.Tensor, what: str) -> int:
    """Raise on inputs the kernels do not take; returns the launch stream."""
    if t.dim() != 3 or t.dtype not in build.DTYPE_CODES:
        raise ValueError(f"{what} takes a (B, ., H) f32 or bf16 tensor, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if ends.dtype != torch.int32 or ends.dim() != 2 or ends.shape[0] != t.shape[0]:
        raise ValueError(f"{what} takes int32 ends (B, P), got {tuple(ends.shape)} {ends.dtype}")
    return kernel_stream(t, ends)


def regulate_fwd(x: torch.Tensor, ends: torch.Tensor, max_frames: int) -> torch.Tensor:
    """Launch the expand kernel: x (B, P, H), ends (B, P) int32 running
    duration sums -> frames (B, max_frames, H). CUDA only."""
    stream = _check(x, ends, "regulate")
    B, P, H = x.shape
    out = torch.empty(B, max_frames, H, dtype=x.dtype, device=x.device)
    lib, fn, _ = _fns()
    rc = fn(x.data_ptr(), ends.data_ptr(), out.data_ptr(), B, P, max_frames, H,
            x.element_size(), stream)
    build.check(lib, rc, "regulate")
    regulate.launches += 1
    return out


def regulate_bwd(g: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Launch the segment-sum kernel: frame gradients g (B, T, H) -> phone
    gradients (B, P, H) in g's dtype, summed in f32. CUDA only."""
    g = g.contiguous()
    stream = _check(g, ends, "regulate_bwd")
    B, T, H = g.shape
    P = ends.shape[1]
    dx = torch.empty(B, P, H, dtype=g.dtype, device=g.device)
    lib, _, fn = _fns()
    rc = fn(g.data_ptr(), ends.data_ptr(), dx.data_ptr(), B, P, T, H, build.DTYPE_CODES[g.dtype],
            stream)
    build.check(lib, rc, "regulate_bwd")
    regulate_bwd.launches += 1
    return dx


class _Regulate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ends, max_frames):
        ctx.save_for_backward(ends)
        return regulate_fwd(x, ends, max_frames)

    @staticmethod
    def backward(ctx, g):
        (ends,) = ctx.saved_tensors
        return regulate_bwd(g, ends), None, None


def regulate_kernel(x: torch.Tensor, durations: torch.Tensor,
                    max_frames: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``regulate_pallas`` for x (B, P, H): (frames (B, T, H), frame_mask
    (B, T)), through the kernels (f32 or bf16, CUDA tensors); raises on
    anything else. ``regulate_plain`` is its plain version."""
    ends = torch.cumsum(durations.clamp(min=0).to(torch.int32), dim=-1,
                        dtype=torch.int32).contiguous()
    frames = _Regulate.apply(x.contiguous(), ends, max_frames)
    t = torch.arange(max_frames, device=x.device)
    mask = t[None, :] < torch.clamp(ends[:, -1], max=max_frames)[:, None]
    return frames, mask


def round_durations_deterministic(log_duration_pred: torch.Tensor) -> torch.Tensor:
    """round(exp(pred) - 1), clamped >= 0 (round half to even, as jnp)."""
    return torch.clamp(torch.round(torch.exp(log_duration_pred) - 1.0),
                       min=0.0).to(torch.int64)


def rescue_zero_durations(durations: torch.Tensor,
                          phone_mask: torch.Tensor) -> torch.Tensor:
    """If an utterance's total duration <= half its phone count, set all its
    valid phones to duration 1. phone_mask True = valid."""
    zero = torch.zeros((), dtype=durations.dtype, device=durations.device)
    total = torch.where(phone_mask, durations, zero).sum(-1)
    n_phones = phone_mask.sum(-1)
    degenerate = total <= n_phones // 2
    ones = torch.where(phone_mask, torch.ones_like(durations), durations)
    return torch.where(degenerate[:, None], ones, durations)


regulate.launches = 0
regulate_bwd.launches = 0

"""Length regulation: expand phone-level states to frame level by duration.

Counterpart of ``lightningfastspeech2_tpu/ops/length_regulator.py`` and
``ops/pallas_length_regulator.py``. With a static output length T, frame t
of item b copies phone #{ends <= t}, where ``ends`` is the running sum of
the durations; frames past the item's total are zero and the returned mask
is True at valid frames.

``regulate`` is the gather (``regulate_plain``), the JAX package's default.
The JAX package's own opt-in, ``LFS2_PALLAS_LR`` set to ``1``, ``true`` or
``on`` (read at each call), routes a 3-D ``x`` on a CUDA tensor with
``max_frames % 256 == 0`` to ``regulate_kernel``: one launch of
``csrc/length_regulator.cu``'s forward kernel, which takes the durations
and writes the frames, the mask and the running sums, and one of its
backward kernel, the segment-sum from those sums (``regulate_pallas``'s
``_expand_kernel`` and ``_grad_kernel`` with the work around them), through
an autograd Function. The switch turns a kernel on, never off.
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


SM_COUNT = 132         # the H100 SXM's SMs
WARPS_PER_BLOCK = 8    # the backward's blocks (kWarps in the .cu)
# the forward's frames a block and the backward's warps a phone run: the
# plans pick one of each
FRAMES_PER_BLOCK = (16, 32, 64, 128, 256)
BWD_SPLITS = (1, 2, 4, 8)


def fwd_frames_per_block(B: int, T: int) -> int:
    """The forward's run of frames a block: the longest in FRAMES_PER_BLOCK
    whose grid, B * ceil(T / F) blocks, still gives every SM a block, else
    the shortest."""
    for F in reversed(FRAMES_PER_BLOCK):
        if B * -(-T // F) >= SM_COUNT:
            return F
    return FRAMES_PER_BLOCK[0]


def bwd_warps_per_phone(B: int, P: int, H: int, elem_bytes: int) -> int:
    """The backward's warps a phone run, S: the kernel deals the run's
    frames among S warps and adds their f32 partial sums in warp order. The
    least S in BWD_SPLITS that gives every SM a block of WARPS_PER_BLOCK
    warps, counting a warp for each 512 bytes of a phone's row (16 bytes a
    lane), else the most. From the shape alone, not g's strides, so that
    every layout of g sums in the same order."""
    units = B * P * -(-H * elem_bytes // 512)
    for S in BWD_SPLITS:
        if units * S >= SM_COUNT * WARPS_PER_BLOCK:
            return S
    return BWD_SPLITS[-1]


def regulate_fwd_plain(x: torch.Tensor, durations: torch.Tensor, max_frames: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernel's contract in PyTorch: (frames (B, T, H), mask
    (B, T), ends (B, P) int32), ends the running sums of the durations
    clamped at 0 and cast to int32, in the JAX order."""
    ends = torch.cumsum(durations.clamp(min=0).to(torch.int32), dim=-1, dtype=torch.int32)
    frames, mask = regulate_plain(x, durations, max_frames)
    return frames, mask, ends


def regulate_bwd_plain(g: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """The backward kernel's contract in PyTorch: frame gradients g (B, T,
    H) -> phone gradients (B, P, H) in g's dtype, each phone's frames below
    the item's total summed in f32 and rounded once."""
    B, T, H = g.shape
    P = ends.shape[1]
    t = torch.arange(T, device=g.device)
    # the phone owning frame t; P (a row thrown away) for frames past the total
    idx = torch.searchsorted(ends.long(), t.expand(B, T).contiguous(), right=True)
    dx = torch.zeros(B, P + 1, H, dtype=torch.float32, device=g.device)
    dx.scatter_add_(1, idx[:, :, None].expand(-1, -1, H), g.float())
    return dx[:, :P].to(g.dtype)


def _fns():
    global _c_fns
    if _c_fns is None:
        lib = build.load("length_regulator")
        p, i = ctypes.c_void_p, ctypes.c_int
        fwd, bwd = lib.lfs2_regulate_fwd, lib.lfs2_regulate_bwd
        q = ctypes.c_longlong
        fwd.argtypes = [p, q, q, q, p, q, q, i, p, p, p, i, i, i, i, i, i, p]
        bwd.argtypes = [p, q, q, q, p, p, i, i, i, i, i, i, p]
        fwd.restype = bwd.restype = ctypes.c_int
        _c_fns = (lib, fwd, bwd)
    return _c_fns


def regulate_fwd(x: torch.Tensor, durations: torch.Tensor, max_frames: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the forward kernel: x (B, P, H) f32 or bf16, durations (B, P)
    int32 or int64 (either with any strides) -> (frames (B, T, H), mask
    (B, T), ends (B, P) int32) with T = ``max_frames``; one launch, CUDA
    only. ``regulate_fwd_plain`` is its plain version."""
    if x.dim() != 3 or x.dtype not in build.DTYPE_CODES:
        raise ValueError(f"regulate takes a (B, P, H) f32 or bf16 x, got "
                         f"{tuple(x.shape)} {x.dtype}")
    B, P, H = x.shape
    if (durations.shape != (B, P) or durations.dtype not in (torch.int32, torch.int64)
            or min(B, P, H, max_frames) < 1):
        raise ValueError(f"regulate takes int32 or int64 durations {(B, P)} and at least one "
                         f"frame, got {tuple(durations.shape)} {durations.dtype}, {max_frames}")
    stream = kernel_stream(strided=(x, durations))
    F = fwd_frames_per_block(B, max_frames)
    frames = torch.empty(B, max_frames, H, dtype=x.dtype, device=x.device)
    mask = torch.empty(B, max_frames, dtype=torch.bool, device=x.device)
    ends = torch.empty(B, P, dtype=torch.int32, device=x.device)
    lib, fn, _ = _fns()
    rc = fn(x.data_ptr(), *x.stride(), durations.data_ptr(), *durations.stride(),
            durations.element_size(), frames.data_ptr(), mask.data_ptr(), ends.data_ptr(),
            B, P, max_frames, H, x.element_size(), F, stream)
    build.check(lib, rc, "regulate")
    regulate.launches += 1
    return frames, mask, ends


def regulate_bwd(g: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Launch the backward kernel: frame gradients g (B, T, H), with any
    strides, and the forward's ends (B, P) int32 -> phone gradients (B, P,
    H) in g's dtype, summed in f32; one launch, CUDA only.
    ``regulate_bwd_plain`` is its plain version."""
    if g.dim() != 3 or g.dtype not in build.DTYPE_CODES:
        raise ValueError(f"regulate_bwd takes a (B, T, H) f32 or bf16 g, got "
                         f"{tuple(g.shape)} {g.dtype}")
    if ends.dtype != torch.int32 or ends.dim() != 2 or ends.shape[0] != g.shape[0]:
        raise ValueError(f"regulate_bwd takes int32 ends (B, P), got {tuple(ends.shape)} "
                         f"{ends.dtype}")
    stream = kernel_stream(ends, strided=(g,))
    B, T, H = g.shape
    P = ends.shape[1]
    dx = torch.empty(B, P, H, dtype=g.dtype, device=g.device)
    lib, _, fn = _fns()
    rc = fn(g.data_ptr(), *g.stride(), ends.data_ptr(), dx.data_ptr(), B, P, T, H,
            build.DTYPE_CODES[g.dtype], bwd_warps_per_phone(B, P, H, g.element_size()), stream)
    build.check(lib, rc, "regulate_bwd")
    regulate_bwd.launches += 1
    return dx


class _Regulate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, durations, max_frames):
        frames, mask, ends = regulate_fwd(x, durations, max_frames)
        ctx.mark_non_differentiable(mask, ends)
        ctx.save_for_backward(ends)
        # no zero gradients made for the mask and ends: a launch each
        ctx.set_materialize_grads(False)
        return frames, mask, ends

    @staticmethod
    def backward(ctx, g, _mask, _ends):
        if g is None:
            return None, None, None
        (ends,) = ctx.saved_tensors
        return regulate_bwd(g, ends), None, None


def regulate_kernel(x: torch.Tensor, durations: torch.Tensor,
                    max_frames: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``regulate_pallas`` for x (B, P, H): (frames (B, T, H), frame_mask
    (B, T)), one kernel launch forward and one backward (f32 or bf16, CUDA
    tensors); raises on anything else. ``regulate_plain`` is its plain
    version."""
    if torch.is_grad_enabled() and x.requires_grad:
        frames, mask, _ = _Regulate.apply(x, durations, max_frames)
    else:
        frames, mask, _ = regulate_fwd(x, durations, max_frames)
    return frames, mask


def round_durations_deterministic(log_duration_pred: torch.Tensor) -> torch.Tensor:
    """round(exp(pred) - 1), clamped >= 0 (round half to even, as jnp)."""
    return torch.clamp(torch.round(torch.exp(log_duration_pred) - 1.0),
                       min=0.0).to(torch.int64)


def round_durations_stochastic(log_duration_pred: torch.Tensor) -> torch.Tensor:
    """The SDP's rounding: ceil(exp(pred + 1e-9)), 0 where the prediction is
    exactly 0, clamped >= 0 (model.py:302-305)."""
    rounded = torch.ceil(torch.exp(log_duration_pred + 1e-9))
    rounded = torch.where(log_duration_pred == 0, torch.zeros_like(rounded), rounded)
    return torch.clamp(rounded, min=0.0).to(torch.int64)


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

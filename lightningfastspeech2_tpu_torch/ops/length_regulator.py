"""Length regulation: expand phone-level states to frame level by duration.

Counterpart of ``lightningfastspeech2_tpu/ops/length_regulator.py``. With a
static output length T, frame t of item b copies phone #{ends <= t}, where
``ends`` is the running sum of the durations; frames past the item's total
are zero and the returned mask is True at valid frames. The JAX package's
opt-in Pallas version (``regulate_pallas``) is not on the serving path and
is not ported yet; this is its default path, a gather.
"""

from __future__ import annotations

from typing import Tuple

import torch


def regulate(x: torch.Tensor, durations: torch.Tensor,
             max_frames: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, P, H) or (B, P), durations (B, P) -> (frames (B, T, ...),
    frame_mask (B, T)) with T = ``max_frames``."""
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

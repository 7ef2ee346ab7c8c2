"""Depthwise, grouped and pointwise 1-D convolutions in the (B, T, C)
layout, with torch-layout weights.

Counterpart of ``lightningfastspeech2_tpu/ops/depthwise.py``. The JAX
package wrote these as shift-multiply loops only to dodge a slow TPU
compile; they are not Pallas kernels there, and here they are
``F.conv1d(groups=...)``. SAME padding is torch's ``padding="same"`` for
stride 1: left ``(k-1)//2``, right ``k//2``.

Weights keep torch's Conv1d layout: depthwise ``(C, 1, k)``, grouped
``(G*co, ci, k)``, pointwise ``(out, in, 1)``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def same_pad(k: int):
    return (k - 1) // 2, k // 2


def grouped_conv1d(x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor], groups: int, dilation: int = 1) -> torch.Tensor:
    """x (B, T, G*ci), w (G*co, ci, k) -> (B, T, G*co), SAME padding over
    the dilated kernel's span (k - 1) * dilation + 1."""
    lpad, rpad = same_pad((w.shape[-1] - 1) * dilation + 1)
    xt = F.pad(x.transpose(1, 2), (lpad, rpad))
    return F.conv1d(xt, w, b, groups=groups, dilation=dilation).transpose(1, 2)


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, dilation: int = 1) -> torch.Tensor:
    """x (B, T, C), w (C, 1, k) -> (B, T, C), SAME padding."""
    return grouped_conv1d(x, w, b, groups=x.shape[-1], dilation=dilation)


def pointwise_conv1d(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, T, in), w (out, in, 1) -> (B, T, out)."""
    return F.linear(x, w[:, :, 0], b)

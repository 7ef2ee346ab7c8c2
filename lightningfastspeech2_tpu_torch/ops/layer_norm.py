"""LayerNorm with flax ``nn.LayerNorm`` numerics.

Counterpart of ``layer_norm_fn`` in ``lightningfastspeech2_tpu/models/
layers.py``: f32 statistics with the fast variance ``max(E[x^2] - E[x]^2,
0)``, ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in f32, then a
cast to the working dtype. ``F.layer_norm`` uses the two-pass variance and
would drift from the reference.
"""

from __future__ import annotations

import torch


def layer_norm_fn(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  dtype: torch.dtype, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    mean2 = (xf * xf).mean(-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps) * scale.float()
    return ((xf - mean) * mul + bias.float()).to(dtype)

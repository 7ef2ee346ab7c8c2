"""Transformer/FFT-block building blocks.

Counterpart of ``lightningfastspeech2_tpu/models/layers.py``: post-norm
self-attention + conformer conv-FFN blocks (the reference's torch
TransformerEncoderLayer with the linear FFN swapped for depthwise-separable
convs). Activations are (B, T, C); masks are True = valid.

Parameters are named like the reference torch state dict
(``self_attn.in_proj_weight``, ``norm1``, ``conv1.0``/``conv1.1``,
``conv2.0``/``conv2.1``), so ``utils/torch_convert.py`` of the JAX package
maps them onto its tree. Parameters stay f32; each block computes in the
working dtype given at construction, like flax's ``dtype``.

The FFN half (LN1 -> ConvFFN -> residual -> LN2) always goes through
``ops.ffn.ffn_ln``: the CUDA kernel on the card, its plain version on the
CPU. Its kernel layouts are prepared when weights load. Only the
depthwise conformer FFN is ported (every config of the serving slice).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from lightningfastspeech2_tpu_torch.core.config import StackConfig
from lightningfastspeech2_tpu_torch.ops.ffn import ffn_ln, prepare_ffn_weights
from lightningfastspeech2_tpu_torch.ops.layer_norm import layer_norm_fn

__all__ = ["LayerNorm", "PositionalEncoding", "SelfAttention", "FFTBlock",
           "FFTStack", "layer_norm_fn", "linear"]


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """A Dense layer in the working dtype (flax ``nn.Dense(dtype=...)``)."""
    b = layer.bias.to(dtype) if layer.bias is not None else None
    return F.linear(x.to(dtype), layer.weight.to(dtype), b)


class LayerNorm(nn.Module):
    """LayerNorm parameters (``weight``/``bias``, torch names) computed with
    flax numerics (``layer_norm_fn``)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps = eps

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return layer_norm_fn(x, self.weight, self.bias, dtype, self.eps)


class PositionalEncoding(nn.Module):
    """Sinusoidal additive positional encoding (no parameters)."""

    def __init__(self, d_model: int, max_len: int = 5000):
        super().__init__()
        position = torch.arange(max_len, dtype=torch.float32)[:, None]
        div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32)
                             * (-math.log(10000.0) / d_model))
        pe = torch.zeros(max_len, d_model)
        pe[:, 0::2] = torch.sin(position * div_term)
        pe[:, 1::2] = torch.cos(position * div_term)
        self.register_buffer("pe", pe, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.pe[None, : x.shape[1], :].to(x.dtype)


class SelfAttention(nn.Module):
    """torch ``nn.MultiheadAttention`` math with packed qkv and a key-padding
    mask: padded keys get ``finfo.min`` before the softmax. Plain matmul +
    softmax, as the JAX package's deterministic path (its flash kernel is
    training-only)."""

    def __init__(self, hidden: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.hidden, self.heads, self.dtype = hidden, heads, dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * hidden, hidden))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * hidden))
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, _ = x.shape
        dt = self.dtype
        hd = self.hidden // self.heads
        qkv = F.linear(x.to(dt), self.in_proj_weight.to(dt), self.in_proj_bias.to(dt))
        q, k, v = (a.reshape(B, T, self.heads, hd).transpose(1, 2)
                   for a in qkv.split(self.hidden, dim=-1))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        if mask is not None:
            neg = torch.finfo(scores.dtype).min
            scores = scores.masked_fill(~mask[:, None, None, :], neg)
        probs = torch.softmax(scores, dim=-1)
        out = (probs @ v).transpose(1, 2).reshape(B, T, self.hidden)
        return linear(out, self.out_proj, dt)


class FFTBlock(nn.Module):
    """One post-norm FFT block: x + MHA -> [LN1 -> ConvFFN -> residual ->
    LN2] with the bracket as one ``ffn_ln`` call."""

    def __init__(self, hidden: int, heads: int, kernel_size: int,
                 filter_size: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.self_attn = SelfAttention(hidden, heads, dtype)
        self.norm1 = LayerNorm(hidden)
        self.norm2 = LayerNorm(hidden)
        # reference ConvFFN (depthwise-separable): conv1 = depthwise k +
        # pointwise up; conv2 = grouped k=1 conv with groups=hidden over
        # filter_size channels (the reference quirk) + pointwise down
        self.conv1 = nn.ModuleList([
            nn.Conv1d(hidden, hidden, kernel_size, groups=hidden),
            nn.Conv1d(hidden, filter_size, 1),
        ])
        self.conv2 = nn.ModuleList([
            nn.Conv1d(filter_size, filter_size, 1, groups=hidden),
            nn.Conv1d(filter_size, hidden, 1),
        ])
        self.ffn_weights = None
        self.prepare()
        self.register_load_state_dict_post_hook(lambda m, _keys: m.prepare())

    def prepare(self) -> None:
        """(Re)build the ``ffn_ln`` kernel layouts from the parameters."""
        self.ffn_weights = prepare_ffn_weights(
            self.conv1[0], self.conv1[1], self.conv2[0], self.conv2[1],
            self.norm1, self.norm2, self.dtype)

    def _apply(self, fn, *args, **kwargs):
        # moving the module (``.to(device)``) rebuilds the prepared layouts
        # on the new device
        out = super()._apply(fn, *args, **kwargs)
        if self.ffn_weights is not None:
            self.prepare()
        return out

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                additional_src: Optional[torch.Tensor] = None) -> torch.Tensor:
        if additional_src is not None:
            x = x + additional_src
        sa = self.self_attn(x, mask)
        return ffn_ln((x.to(self.dtype) + sa).contiguous(), self.ffn_weights)


class FFTStack(nn.Module):
    """Encoder/decoder stack; layer i uses ``kernel_sizes[i]`` for its
    depthwise conv."""

    def __init__(self, cfg: StackConfig, dtype: torch.dtype):
        super().__init__()
        if not (cfg.conformer and cfg.depthwise):
            raise NotImplementedError(
                "the port runs the depthwise conformer FFT block only")
        self.layers = nn.ModuleList([
            FFTBlock(cfg.hidden, cfg.heads, k, cfg.conv_filter_size, dtype)
            for k in cfg.kernel_sizes
        ])

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                additional_src: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, mask, additional_src)
        return x

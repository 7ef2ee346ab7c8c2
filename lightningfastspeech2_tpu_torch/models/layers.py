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

``module.train()`` / ``.eval()`` is the counterpart of flax's
``deterministic``. Training-mode forwards take a ``torch.Generator`` for
every dropout and every kernel seed. The FFN half (LN1 -> ConvFFN ->
residual -> LN2) of a depthwise conformer block at the widths
``ffn_fused_ok`` admits goes through one call: ``ops.ffn.ffn_ln`` in eval
mode, ``ops.ffn.ffn_ln_train`` in training; the CUDA kernels on the card,
their plain versions on the CPU. Every other block (the plain ConvFFN, the
linear FFN of a non-conformer stack, and widths the gate refuses) runs the
FFN half unfused, with ``F.conv1d`` / ``F.linear`` and the generator's
dropout, as the JAX package runs it outside its kernels.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from lightningfastspeech2_tpu_torch.core.config import StackConfig
from lightningfastspeech2_tpu_torch.ops.attention import flash_attention
from lightningfastspeech2_tpu_torch.ops.depthwise import (
    depthwise_conv1d,
    grouped_conv1d,
    pointwise_conv1d,
)
from lightningfastspeech2_tpu_torch.ops.dropout import draw_seed, dropout
from lightningfastspeech2_tpu_torch.ops.ffn import (
    ffn_ln,
    ffn_ln_train,
    ffn_train_params,
    fold_grouped_into_down,
    prepare_ffn_weights,
)
from lightningfastspeech2_tpu_torch.ops.layer_norm import layer_norm_fn

__all__ = ["LayerNorm", "PositionalEncoding", "SelfAttention", "FFTBlock",
           "FFTStack", "ffn_fused_ok", "flash_ok", "layer_norm_fn", "linear"]


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
    """Sinusoidal additive positional encoding (no parameters), then dropout
    in training."""

    def __init__(self, d_model: int, max_len: int = 5000, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        position = torch.arange(max_len, dtype=torch.float32)[:, None]
        div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32)
                             * (-math.log(10000.0) / d_model))
        pe = torch.zeros(max_len, d_model)
        pe[:, 0::2] = torch.sin(position * div_term)
        pe[:, 1::2] = torch.cos(position * div_term)
        self.register_buffer("pe", pe, persistent=False)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.pe[None, : x.shape[1], :].to(x.dtype)
        return dropout(x, self.dropout, generator) if self.training else x


def flash_ok(T: int, head_dim: int, training: bool) -> bool:
    """The JAX package's gate for the fused attention kernel
    (``models/layers.py _flash_ok``), exactly: training mode, T >= 1024,
    T % 128 == 0 and head_dim % 128 == 0. Elsewhere attention is the plain
    matmul path with the generator's dropout, as the JAX package runs it
    outside its kernel."""
    return training and T >= 1024 and T % 128 == 0 and head_dim % 128 == 0


# the JAX package's fit estimate for its training FFN kernel: both pointwise
# weights in two layouts plus f32 partials (16 C F bytes) and three f32
# (tile + halo, F) intermediates at the backward's tile, within 14 MiB
_JAX_TRAIN_FIT = 14 * 1024 * 1024


def ffn_fused_ok(hidden: int, filter_size: int, training: bool) -> bool:
    """Whether a depthwise conformer block (grouped conv of kernel 1) runs its
    FFN half as one fused kernel call: the JAX package's gate
    (``models/layers.py _fused_ffn_ok``) as it runs on the chip, on the CPU
    and on the card alike. Hidden and filter must be multiples of 128; in
    training the JAX fit estimate ``16 C F + 3 * 320 * F * 4 <= 14 MiB``
    must hold too. The port's training kernels take every width it admits
    (``ops.ffn.ffn_train_fits``), and raise on the card at a kernel size
    past their reach."""
    if hidden % 128 or filter_size % 128:
        return False
    return not training or (16 * hidden * filter_size + 3 * (256 + 64) * filter_size * 4
                            <= _JAX_TRAIN_FIT)


class SelfAttention(nn.Module):
    """torch ``nn.MultiheadAttention`` math with packed qkv and a key-padding
    mask. Plain matmul + softmax (padded keys at ``finfo.min``), with
    dropout on the probabilities in training; in training at the flash
    gate's shapes, ``ops.attention.flash_attention`` instead."""

    def __init__(self, hidden: int, heads: int, dtype: torch.dtype,
                 dropout: float = 0.1):
        super().__init__()
        self.hidden, self.heads, self.dtype = hidden, heads, dtype
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * hidden, hidden))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * hidden))
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, _ = x.shape
        dt = self.dtype
        hd = self.hidden // self.heads
        qkv = F.linear(x.to(dt), self.in_proj_weight.to(dt), self.in_proj_bias.to(dt))
        q, k, v = (a.reshape(B, T, self.heads, hd).transpose(1, 2)
                   for a in qkv.split(self.hidden, dim=-1))
        if flash_ok(T, hd, self.training):
            rate = self.dropout
            seed = draw_seed(generator, x.device) if rate > 0.0 else None
            out = flash_attention(q, k, v, mask, rate, seed).to(dt)
        else:
            scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
            if mask is not None:
                neg = torch.finfo(scores.dtype).min
                scores = scores.masked_fill(~mask[:, None, None, :], neg)
            probs = torch.softmax(scores, dim=-1)
            if self.training:
                probs = dropout(probs, self.dropout, generator)
            out = probs @ v
        out = out.transpose(1, 2).reshape(B, T, self.hidden)
        return linear(out, self.out_proj, dt)


class FFTBlock(nn.Module):
    """One post-norm FFT block: x + MHA -> [LN1 -> FFN -> residual -> LN2].

    The FFN is the reference ConvFFN (``conformer``; depthwise-separable or
    a plain conv pair) or the vanilla linear FFN. Where ``ffn_fused_ok``
    admits a depthwise block, the bracket is one ``ffn_ln`` call (eval) or
    one ``ffn_ln_train`` call (training, with the block's f32 parameters
    and a seed drawn from the step's generator); otherwise it runs unfused,
    dropout after the ReLU and after the FFN, as the JAX package's
    ``ConvFFN`` / ``LinearFFN``."""

    def __init__(self, hidden: int, heads: int, kernel_size: int,
                 filter_size: int, dtype: torch.dtype, dropout: float = 0.1,
                 conformer: bool = True, depthwise: bool = True,
                 dim_feedforward: Optional[int] = None):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.conformer, self.depthwise = conformer, depthwise and conformer
        self.self_attn = SelfAttention(hidden, heads, dtype, dropout)
        self.norm1 = LayerNorm(hidden)
        self.norm2 = LayerNorm(hidden)
        if self.depthwise:
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
        elif conformer:  # plain ConvFFN: conv k up, conv 1 down
            self.conv1 = nn.Conv1d(hidden, filter_size, kernel_size)
            self.conv2 = nn.Conv1d(filter_size, hidden, 1)
        else:  # the vanilla transformer FFN
            inner = dim_feedforward or filter_size
            self.linear1 = nn.Linear(hidden, inner)
            self.linear2 = nn.Linear(inner, hidden)
        self._ffn, self._ffn_key = None, None

    def fused(self) -> bool:
        """Whether this forward runs the FFN half as one fused call."""
        return self.depthwise and ffn_fused_ok(
            self.norm1.weight.shape[0], self.conv1[1].weight.shape[0], self.training)

    def _ffn_modules(self):
        return (self.conv1[0], self.conv1[1], self.conv2[0], self.conv2[1],
                self.norm1, self.norm2)

    @property
    def ffn_weights(self):
        """The ``ffn_ln`` kernel layouts, rebuilt whenever a parameter they
        come from changed (an optimizer step, a load, a move to another
        device): keyed on each parameter's storage and version counter."""
        key = tuple((p.data_ptr(), p._version)
                    for m in self._ffn_modules() for p in (m.weight, m.bias))
        if key != self._ffn_key:
            self._ffn = prepare_ffn_weights(*self._ffn_modules(), self.dtype)
            self._ffn_key = key
        return self._ffn

    def _drop(self, h: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        return dropout(h, self.dropout, generator) if self.training else h

    def _ffn_unfused(self, x: torch.Tensor,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
        """The FFN alone, in the working dtype: ConvFFN or LinearFFN."""
        dt = self.dtype
        if self.depthwise:
            c1, c2 = self.conv1, self.conv2
            h = depthwise_conv1d(x, c1[0].weight.to(dt), c1[0].bias.to(dt))
            h = pointwise_conv1d(h, c1[1].weight.to(dt), c1[1].bias.to(dt))
            h = self._drop(torch.relu(h), generator)
            # the grouped k=1 conv and the pointwise down conv, linear with
            # nothing between them, as one (F, C) product, as the fused
            # kernels take them (a grouped conv's weight gradient runs one
            # library launch a group)
            w2f, b2f = fold_grouped_into_down(c2[0].weight, c2[0].bias, c2[1].weight,
                                              c2[1].bias, groups=self.norm1.weight.shape[0])
            h = h @ w2f.to(dt) + b2f.to(dt)
        elif self.conformer:
            h = grouped_conv1d(x, self.conv1.weight.to(dt), self.conv1.bias.to(dt), 1)
            h = self._drop(torch.relu(h), generator)
            h = grouped_conv1d(h, self.conv2.weight.to(dt), self.conv2.bias.to(dt), 1)
        else:
            h = self._drop(torch.relu(linear(x, self.linear1, dt)), generator)
            h = linear(h, self.linear2, dt)
        return self._drop(h, generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                additional_src: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if additional_src is not None:
            x = x + additional_src
        sa = self._drop(self.self_attn(x, mask, generator), generator)
        z = (x.to(self.dtype) + sa).contiguous()
        if not self.fused():
            t1 = self.norm1(z, self.dtype)
            return self.norm2(t1 + self._ffn_unfused(t1, generator), self.dtype)
        if not self.training:
            return ffn_ln(z, self.ffn_weights)
        return ffn_ln_train(z, ffn_train_params(*self._ffn_modules()),
                            draw_seed(generator, z.device), self.dropout)


class FFTStack(nn.Module):
    """Encoder/decoder stack; layer i uses ``kernel_sizes[i]`` for its first
    conv (3 in a non-conformer stack, whose blocks have no conv)."""

    def __init__(self, cfg: StackConfig, dtype: torch.dtype):
        super().__init__()
        kernels = cfg.kernel_sizes if cfg.conformer else (3,) * cfg.layers
        self.layers = nn.ModuleList([
            FFTBlock(cfg.hidden, cfg.heads, k, cfg.conv_filter_size, dtype, cfg.dropout,
                     conformer=cfg.conformer, depthwise=cfg.depthwise,
                     dim_feedforward=cfg.dim_feedforward)
            for k in kernels
        ])

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                additional_src: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, mask, additional_src, generator)
        return x

"""Stochastic (flow-based) duration predictor, VITS-style.

Counterpart of ``lightningfastspeech2_tpu/models/sdp.py`` (reference
``litfass/third_party/stochastic_duration_predictor/sdp.py``): a
text-conditioned encoder (1x1 conv + dilated depthwise-separable conv
stack), a posterior encoder over the durations for variational
dequantization (z_u) and augmentation (z_v), then ElementwiseAffine and N
ConvFlow rational-quadratic-spline coupling layers. Training returns the
per-item NLL; inference runs the flows in reverse from scaled noise and
returns log-durations, without the unused flow (sdp.py:338).

Layout is (B, T, C) throughout; masks are True = valid; the channel flip
between flows is ``torch.flip`` on the last axis. Every 1x1 conv, the
depthwise convs and the LayerNorms compute in the working dtype as the JAX
Dense / LayerNorm with ``dtype`` do; the encoder output is cast to f32 after
``proj``, and a residual that adds a f32 tensor to one in the working dtype
promotes to f32, as jnp does. The noise comes from a ``Draws`` source under
the module's name (``models/draws.py``).

Parameters are named like the reference torch state dict: ``pre``,
``convs.convs_sep.{i}`` / ``convs_1x1.{i}`` / ``norms_{1,2}.{i}.gamma|beta``,
``proj``, ``flows.{0..n}`` (``flows.0`` the ElementwiseAffine's
``translation`` / ``log_scale``, (2, 1)), and the ``post_*`` twins.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from lightningfastspeech2_tpu_torch.models.draws import Draws
from lightningfastspeech2_tpu_torch.ops.depthwise import depthwise_conv1d
from lightningfastspeech2_tpu_torch.ops.dropout import dropout
from lightningfastspeech2_tpu_torch.ops.layer_norm import layer_norm_fn
from lightningfastspeech2_tpu_torch.ops.splines import piecewise_rational_quadratic_transform


def conv1x1(x: torch.Tensor, conv: nn.Conv1d, dtype: torch.dtype) -> torch.Tensor:
    """A (out, in, 1) Conv1d on (B, T, in) as the JAX Dense in ``dtype``."""
    return F.linear(x.to(dtype), conv.weight[:, :, 0].to(dtype), conv.bias.to(dtype))


class LayerNorm2(nn.Module):
    """The reference's channel LayerNorm (``gamma``, ``beta``), computed with
    flax numerics in the working dtype."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return layer_norm_fn(x, self.gamma, self.beta, dtype, self.eps)


class DilatedDepthSeparableConv(nn.Module):
    """num_layers x [depthwise(k, dilation k^i) -> LN -> GELU -> 1x1 -> LN ->
    GELU -> dropout] with a residual (sdp.py:11-73)."""

    def __init__(self, channels: int, kernel_size: int, num_layers: int,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout, self.dtype = dropout, dtype
        self.convs_sep = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, groups=channels,
                      dilation=kernel_size ** i, padding=(kernel_size ** i * (kernel_size - 1)) // 2)
            for i in range(num_layers)])
        self.convs_1x1 = nn.ModuleList([nn.Conv1d(channels, channels, 1)
                                        for _ in range(num_layers)])
        self.norms_1 = nn.ModuleList([LayerNorm2(channels) for _ in range(num_layers)])
        self.norms_2 = nn.ModuleList([LayerNorm2(channels) for _ in range(num_layers)])

    def forward(self, x, mask, g=None, generator: Optional[torch.Generator] = None):
        dt = self.dtype
        if g is not None:
            x = x + g
        m = mask[..., None].to(x.dtype)
        for sep, c1, n1, n2 in zip(self.convs_sep, self.convs_1x1, self.norms_1, self.norms_2):
            y = depthwise_conv1d(x * m, sep.weight.to(x.dtype), sep.bias.to(x.dtype),
                                 dilation=sep.dilation[0])
            y = F.gelu(n1(y, dt))
            y = F.gelu(n2(conv1x1(y, c1, dt), dt))
            if self.training and self.dropout > 0:
                y = dropout(y, self.dropout, generator)
            x = x + y
        return x * m


class ElementwiseAffine(nn.Module):
    """y = x exp(s) + t with logdet = sum(s * mask) (sdp.py:76-97)."""

    def __init__(self, channels: int):
        super().__init__()
        self.translation = nn.Parameter(torch.zeros(channels, 1))
        self.log_scale = nn.Parameter(torch.zeros(channels, 1))

    def zero_init(self) -> None:
        with torch.no_grad():
            self.translation.zero_()
            self.log_scale.zero_()

    def forward(self, x, mask, g=None, reverse: bool = False, generator=None):
        t, s = self.translation[:, 0], self.log_scale[:, 0]
        m = mask[..., None].to(x.dtype)
        if not reverse:
            return (x * torch.exp(s) + t) * m, (s * m).sum((1, 2))
        return (x - t) * torch.exp(-s) * m


class ConvFlow(nn.Module):
    """Half-split coupling: a rational-quadratic spline on the second half,
    parameterized by a DDS conv over the first (sdp.py:100-169). ``proj``
    starts at zero, so a new flow is the identity."""

    def __init__(self, in_channels: int, hidden_channels: int, kernel_size: int,
                 num_layers: int, num_bins: int = 10, tail_bound: float = 5.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.half, self.hidden, self.num_bins, self.tail_bound = (
            in_channels // 2, hidden_channels, num_bins, tail_bound)
        self.dtype = dtype
        self.pre = nn.Conv1d(self.half, hidden_channels, 1)
        self.convs = DilatedDepthSeparableConv(hidden_channels, kernel_size, num_layers,
                                               0.0, dtype)
        self.proj = nn.Conv1d(hidden_channels, self.half * (num_bins * 3 - 1), 1)

    def zero_init(self) -> None:
        with torch.no_grad():
            self.proj.weight.zero_()
            self.proj.bias.zero_()

    def forward(self, x, mask, g=None, reverse: bool = False, generator=None):
        dt, half, K = self.dtype, self.half, self.num_bins
        x0, x1 = x[..., :half], x[..., half:]
        m = mask[..., None].to(x.dtype)
        h = conv1x1(x0, self.pre, dt)
        h = self.convs(h, mask, g=g, generator=generator)
        h = conv1x1(h, self.proj, dt) * m
        B, T = x.shape[:2]
        h = h.reshape(B, T, half, -1)
        scale = math.sqrt(self.hidden)
        uw, uh, ud = h[..., :K] / scale, h[..., K:2 * K] / scale, h[..., 2 * K:]
        # the bins in h's dtype, the spline itself promoted with x1's, as jnp
        y1, logabsdet = piecewise_rational_quadratic_transform(
            x1, uw, uh, ud, inverse=reverse, tails="linear", tail_bound=self.tail_bound)
        out = torch.cat([x0.to(y1.dtype), y1], -1) * m
        if not reverse:
            return out, (logabsdet * m).sum((1, 2))
        return out


class StochasticDurationPredictor(nn.Module):
    """x (B, T, C), mask (B, T) True = valid; durations (B, T) in training.

    Training (``reverse=False``): the per-item NLL (B,).
    Inference (``reverse=True``): log-durations (B, T).
    The noise is drawn from ``draws`` under the module's path (sdp.py:172-349)."""

    name = "variance_adaptor.duration_predictor"

    def __init__(self, in_channels: int, filter_size: int, kernel_size: int,
                 dropout: float, n_flows: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        hc, self.dtype = filter_size, dtype
        self.pre = nn.Conv1d(in_channels, hc, 1)
        self.convs = DilatedDepthSeparableConv(hc, kernel_size, 3, dropout, dtype)
        self.proj = nn.Conv1d(hc, hc, 1)
        self.flows = nn.ModuleList([ElementwiseAffine(2)] + [
            ConvFlow(2, hc, kernel_size, 3, dtype=dtype) for _ in range(n_flows)])
        self.post_pre = nn.Conv1d(1, hc, 1)
        self.post_convs = DilatedDepthSeparableConv(hc, kernel_size, 3, dropout, dtype)
        self.post_proj = nn.Conv1d(hc, hc, 1)
        self.post_flows = nn.ModuleList([ElementwiseAffine(2)] + [
            ConvFlow(2, hc, kernel_size, 3, dtype=dtype) for _ in range(n_flows)])

    def forward(self, x, mask, durations=None, reverse: bool = False,
                noise_scale: float = 1.0, draws: Optional[Draws] = None,
                generator: Optional[torch.Generator] = None):
        dt = self.dtype
        m = mask[..., None].float()
        x = conv1x1(x, self.pre, dt)
        x = self.convs(x, mask, generator=generator)
        x = (conv1x1(x, self.proj, dt) * m).float()
        B, T = x.shape[:2]

        if not reverse:
            if durations is None:
                raise ValueError("the SDP's training pass needs durations")
            dr = durations[..., None].float()
            h = conv1x1(dr, self.post_pre, dt)
            h = self.post_convs(h, mask, generator=generator)
            h = (conv1x1(h, self.post_proj, dt) * m).float()
            noise = draws.normal(self.name, (B, T, 2), x.device) * m
            z_q, logdet_tot_q = noise, 0.0
            for idx, flow in enumerate(self.post_flows):
                z_q, logdet_q = flow(z_q, mask, g=x + h, generator=generator)
                logdet_tot_q = logdet_tot_q + logdet_q
                if idx > 0:
                    z_q = torch.flip(z_q, [-1])
            z_u, z_v = z_q[..., :1], z_q[..., 1:]
            u = torch.sigmoid(z_u) * m
            z0 = (dr - u) * m
            logdet_tot_q = logdet_tot_q + (
                (F.logsigmoid(z_u) + F.logsigmoid(-z_u)) * m).sum((1, 2))
            nll_posterior = ((-0.5 * (math.log(2 * math.pi) + noise ** 2) * m).sum((1, 2))
                             - logdet_tot_q)
            z0 = torch.log(torch.clamp(z0, min=1e-5)) * m
            logdet_tot = (-z0).sum((1, 2))
            z = torch.cat([z0, z_v], -1)
            for idx, flow in enumerate(self.flows):
                z, logdet = flow(z, mask, g=x, generator=generator)
                logdet_tot = logdet_tot + logdet
                if idx > 0:
                    z = torch.flip(z, [-1])
            nll_flows = (0.5 * (math.log(2 * math.pi) + z ** 2) * m).sum((1, 2)) - logdet_tot
            return nll_flows + nll_posterior

        flows = list(reversed(self.flows))
        flows = flows[:-2] + [flows[-1]]   # the unused extra flow dropped (sdp.py:338)
        z = draws.normal(self.name, (B, T, 2), x.device) * noise_scale
        for flow in flows:
            z = torch.flip(z, [-1])
            z = flow(z, mask, g=x, reverse=True, generator=generator)
        return z[..., 0]

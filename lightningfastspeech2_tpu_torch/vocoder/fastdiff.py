"""FastDiff vocoder: conditional DDPM over the raw waveform.

Counterpart of ``lightningfastspeech2_tpu/vocoder/fastdiff.py``: 3
DiffusionDBlock downsample stages and 3 time-aware location-variable-
convolution (LVC) upsample stages (ratios 8, 8, 4 = hop 256), with a
sinusoidal step embedding through two swish Linear layers. Serving runs the
reverse sampler (``vocoder.diffusion``) over the hardcoded N-step
schedules; the joint model (``models/joint.py``) trains it on the ε-MSE
through ``FastDiff.forward(..., train_route=True)``.

``FastDiff.forward`` is the port's counterpart of the JAX package's
``eps_apply_fused``: the kernel predictors, the downsample blocks and the
transposed convs run in PyTorch, channel-last (B, L, C) as in the JAX
package; each upsample stage's LVC chain goes to ``ops.fastdiff_lvc.
lvc_stack`` (the CUDA kernel on the card) where the JAX routing rule sends
it to its Pallas kernel (``routes_to_kernel``: stages 2 and 3 at ratios
(8, 8, 4), stage 1 too under ``LFS2_FUSED_STAGE1``), and otherwise through
the plain chain the JAX path keeps.

Parameters are named like the reference torch state dict that
``lightningfastspeech2_tpu/utils/torch_convert.py``
``convert_fastdiff_state_dict`` reads, with weight norm folded. Parameters
stay f32; the working dtype is fixed at construction.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lightningfastspeech2_tpu_torch.core.device import DeviceLike, resolve_device
from lightningfastspeech2_tpu_torch.models.layers import linear
from lightningfastspeech2_tpu_torch.ops.fastdiff_lvc import (  # noqa: F401  (re-exported)
    fast_sigmoid,
    fast_tanh,
    gated_activation,
    location_variable_convolution,
    lvc_stack,
    routes_to_kernel,
)
from lightningfastspeech2_tpu_torch.vocoder import diffusion
from lightningfastspeech2_tpu_torch.vocoder.hifigan import fold_weight_norm_state


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


@dataclass(frozen=True)
class FastDiffConfig:
    audio_channels: int = 1
    inner_channels: int = 32
    cond_channels: int = 80
    upsample_ratios: Tuple[int, ...] = (8, 8, 4)
    lvc_layers_each_block: int = 4
    lvc_kernel_size: int = 3
    kpnet_hidden_channels: int = 64
    kpnet_conv_size: int = 3
    dropout: float = 0.0
    step_embed_dim_in: int = 128
    step_embed_dim_mid: int = 512
    step_embed_dim_out: int = 512
    beta_0: float = 1e-6
    beta_T: float = 0.01
    T: int = 1000
    # opt-in rational sigmoid/tanh gate approximations (serving-speed knob;
    # generate's --vocoder_fast_gating)
    fast_gating: bool = False

    @property
    def hop_length(self) -> int:
        out = 1
        for r in self.upsample_ratios:
            out *= r
        return out


def _leaky(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.maximum(x, x * slope)


def _conv(x: torch.Tensor, conv: nn.Module, dt: torch.dtype) -> torch.Tensor:
    """x (B, L, Cin) through a Conv1d or ConvTranspose1d in the working
    dtype; (B, L', Cout) out."""
    w, b = conv.weight.to(dt), conv.bias.to(dt)
    xt = x.to(dt).transpose(1, 2)
    if isinstance(conv, nn.ConvTranspose1d):
        y = F.conv_transpose1d(xt, w, b, conv.stride, conv.padding)
    else:
        y = F.conv1d(xt, w, b, padding=conv.padding, dilation=conv.dilation)
    return y.transpose(1, 2)


class KernelPredictor(nn.Module):
    """Conditioning convnet -> per-frame LVC kernels (B, nL, layers, Cin,
    Cout, k) and biases (B, nL, layers, Cout) (reference modules.py:257-343).
    ``residual_conv`` keeps the reference's Sequential indices (convs at 1,
    3, 6, 8, 11, 13) with its Dropout and LeakyReLU entries."""

    def __init__(self, cond_channels: int, conv_in_channels: int, conv_out_channels: int,
                 conv_layers: int, conv_kernel_size: int = 3, hidden: int = 64,
                 kpnet_conv_size: int = 3, dropout: float = 0.0):
        super().__init__()
        self.shape = (conv_layers, conv_in_channels, conv_out_channels, conv_kernel_size)
        pad = (kpnet_conv_size - 1) // 2
        self.input_conv = nn.Sequential(nn.Conv1d(cond_channels, hidden, 5, padding=2),
                                        nn.LeakyReLU(0.1))
        mods = []
        for i in range(6):
            if i % 2 == 0:
                mods.append(nn.Dropout(dropout))
            mods += [nn.Conv1d(hidden, hidden, kpnet_conv_size, padding=pad), nn.LeakyReLU(0.1)]
        self.residual_conv = nn.Sequential(*mods)
        l_w = conv_in_channels * conv_out_channels * conv_kernel_size * conv_layers
        self.kernel_conv = nn.Conv1d(hidden, l_w, kpnet_conv_size, padding=pad)
        self.bias_conv = nn.Conv1d(hidden, conv_out_channels * conv_layers, kpnet_conv_size,
                                   padding=pad)

    @staticmethod
    def _conv_frames(h3: torch.Tensor, conv: nn.Conv1d, dt) -> torch.Tensor:
        # one product over the tap-stacked frames (column j * Cin + ci for
        # tap j), so the output is frame-major (B, nL, Cout) as the LVC
        # kernel reads it, with no transposed copy
        w = conv.weight.to(dt).permute(0, 2, 1).reshape(conv.out_channels, -1)
        return F.linear(h3, w, conv.bias.to(dt))

    def forward(self, c: torch.Tensor, dt: torch.dtype):
        h = _leaky(_conv(c, self.input_conv[0], dt), 0.1)
        r = h
        for m in self.residual_conv:
            if isinstance(m, nn.Conv1d):
                r = _leaky(_conv(r, m, dt), 0.1)
        h = h + r
        k = self.kernel_conv.kernel_size[0]
        pad = self.kernel_conv.padding[0]
        hp = F.pad(h, (0, 0, pad, k - 1 - pad))
        nL = h.shape[1]
        h3 = torch.cat([hp[:, j:j + nL] for j in range(k)], dim=-1)
        B = h.shape[0]
        layers, cin, cout, ks = self.shape
        kernels = self._conv_frames(h3, self.kernel_conv, dt).reshape(B, nL, layers, cin, cout, ks)
        bias = self._conv_frames(h3, self.bias_conv, dt).reshape(B, nL, layers, cout)
        return kernels, bias


class DiffusionDBlock(nn.Module):
    """Downsample: nearest-interpolate + 3 dilated convs with a residual
    (modules.py:116-138)."""

    def __init__(self, hidden: int, factor: int):
        super().__init__()
        self.factor = factor
        self.residual_dense = nn.Conv1d(hidden, hidden, 1)
        self.conv = nn.ModuleList([nn.Conv1d(hidden, hidden, 3, dilation=d, padding=d)
                                   for d in (1, 2, 4)])

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        size = x.shape[1] // self.factor
        down = x[:, ::self.factor][:, :size]
        residual = _conv(down, self.residual_dense, dt)
        h = down
        for conv in self.conv:
            h = _conv(_leaky(h, 0.2), conv, dt)
        return h + residual


class TimeAwareLVCBlock(nn.Module):
    """Upsample stage with time-conditioned LVC (modules.py:141-218)."""

    def __init__(self, in_channels: int, cond_channels: int, upsample_ratio: int,
                 conv_layers: int, conv_kernel_size: int, cond_hop_length: int,
                 kpnet_hidden: int, kpnet_conv_size: int, dropout: float,
                 step_embed_dim_out: int):
        super().__init__()
        r = upsample_ratio
        if r % 2:
            raise ValueError("upsample ratios must be even (the reference uses 8, 8, 4)")
        self.channels, self.cond_hop = in_channels, cond_hop_length
        self.fc_t = nn.Linear(step_embed_dim_out, cond_channels)
        self.kernel_predictor = KernelPredictor(
            cond_channels, in_channels, 2 * in_channels, conv_layers, conv_kernel_size,
            kpnet_hidden, kpnet_conv_size, dropout)
        self.upsample = nn.ConvTranspose1d(in_channels, in_channels, 2 * r, r, padding=r // 2)
        self.convs = nn.ModuleList([
            nn.Conv1d(in_channels, in_channels, conv_kernel_size, dilation=3 ** i,
                      padding=3 ** i * (conv_kernel_size - 1) // 2)
            for i in range(conv_layers)])

    def forward(self, x, audio_down, c, emb, dt: torch.dtype, fast: bool,
                train_route: bool = False) -> torch.Tensor:
        noise = linear(emb, self.fc_t, dt)
        kernels, bias = self.kernel_predictor(c.to(dt) + noise[:, None, :], dt)
        h = _conv(_leaky(x, 0.2), self.upsample, dt)
        layers, n_frames = len(self.convs), kernels.shape[1]
        if not train_route and routes_to_kernel(self.cond_hop, n_frames, layers):
            conv_w = torch.stack([m.weight.to(dt).permute(2, 1, 0) for m in self.convs])
            conv_b = torch.stack([m.bias.float() for m in self.convs])
            return lvc_stack(h.contiguous(), audio_down.contiguous(), kernels, bias,
                             conv_w.contiguous(), conv_b, self.cond_hop, fast)
        # the training route, and the chain the serving path keeps where
        # even a whole-tile halo cannot cover the layers' reach
        # (vocoder/fastdiff.py:431-439)
        for i, conv in enumerate(self.convs):
            h = h + audio_down
            y = _leaky(_conv(_leaky(h, 0.2), conv, dt), 0.2)
            y = location_variable_convolution(y, kernels[:, :, i], bias[:, :, i], self.cond_hop)
            h = h + gated_activation(y, self.channels, fast)
        return h


class FastDiff(nn.Module):
    """ε-prediction network: (noisy wav (B, T), mel (B, T', 80), fractional
    steps ts (B,)) -> ε (B, T) in the working dtype (FastDiff.py:91-147).

    Two routes, chosen by the caller as the JAX package chooses between its
    two functions: serving (the default, JAX's ``eps_apply_fused``) sends
    the stages the JAX rule routes to its kernel through ``lvc_stack``;
    ``train_route=True`` (JAX's ``FastDiff.apply``, which its training takes)
    runs every stage's chain in plain PyTorch under autograd."""

    def __init__(self, cfg: FastDiffConfig = FastDiffConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        C, n = cfg.inner_channels, len(cfg.upsample_ratios)
        self.fc_t1 = nn.Linear(cfg.step_embed_dim_in, cfg.step_embed_dim_mid)
        self.fc_t2 = nn.Linear(cfg.step_embed_dim_mid, cfg.step_embed_dim_out)
        self.first_audio_conv = nn.Conv1d(cfg.audio_channels, C, 7, padding=3)
        self.downsample = nn.ModuleList([DiffusionDBlock(C, cfg.upsample_ratios[n - i - 1])
                                         for i in range(n)])
        blocks, hop = [], 1
        for r in cfg.upsample_ratios:
            hop *= r
            blocks.append(TimeAwareLVCBlock(
                C, cfg.cond_channels, r, cfg.lvc_layers_each_block, cfg.lvc_kernel_size, hop,
                cfg.kpnet_hidden_channels, cfg.kpnet_conv_size, cfg.dropout,
                cfg.step_embed_dim_out))
        self.lvc_blocks = nn.ModuleList(blocks)
        self.final_conv = nn.Sequential(nn.Conv1d(C, cfg.audio_channels, 7, padding=3))

    def forward(self, x: torch.Tensor, c: torch.Tensor, ts: torch.Tensor,
                train_route: bool = False) -> torch.Tensor:
        cfg, dt = self.cfg, self.dtype
        emb = diffusion.step_embedding(ts, cfg.step_embed_dim_in).to(dt)
        emb = swish(linear(emb, self.fc_t1, dt))
        emb = swish(linear(emb, self.fc_t2, dt))
        h = _conv(x[..., None], self.first_audio_conv, dt)
        downsampled = []
        for blk in self.downsample:
            downsampled.append(h)
            h = blk(h, dt)
        for n, blk in enumerate(self.lvc_blocks):
            h = blk(h, downsampled[-1 - n], c, emb, dt, cfg.fast_gating, train_route)
        return _conv(h, self.final_conv[0], dt)[..., 0]


@torch.no_grad()
def init_fastdiff_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialization: uniform +-1/sqrt(fan_in) for every conv,
    transposed conv and linear weight and bias (fan_in = weight[0].numel())."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.ConvTranspose1d)):
            bound = m.weight[0].numel() ** -0.5
            m.weight.copy_(torch.empty_like(m.weight).uniform_(-bound, bound, generator=generator))
            m.bias.copy_(torch.empty_like(m.bias).uniform_(-bound, bound, generator=generator))


class FastDiffVocoder:
    """Inference wrapper owning the schedule hyperparameters:
    mel (T', 80) or (B, T', 80) -> waveform (B, T' * hop), f32."""

    def __init__(self, cfg: FastDiffConfig = FastDiffConfig(),
                 state_dict: Optional[Dict[str, object]] = None,
                 dtype: torch.dtype = torch.float32, device: DeviceLike = None, seed: int = 0):
        dev = resolve_device(device)
        self.cfg, self.dtype, self.device = cfg, dtype, dev
        self.model = FastDiff(cfg, dtype)
        if state_dict is not None:
            self.model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in
                                        fold_weight_norm_state(state_dict).items()})
        else:
            init_fastdiff_weights(self.model, torch.Generator().manual_seed(seed))
        self.model.to(dev).eval()
        self.hp = diffusion.compute_hyperparams(
            diffusion.linear_beta_schedule(cfg.beta_0, cfg.beta_T, cfg.T))

    @torch.no_grad()
    def inference(self, mel, N: int = 4, x_T=None, noises=None) -> torch.Tensor:
        """The N-step reverse sampler (FastDiff.py:149-195), peak-normalised
        per item over its whole length. The noise is ``x_T`` and ``noises``
        where given (see ``diffusion.reverse_sample``), else drawn from a
        generator seeded 0 on the vocoder's device."""
        m = torch.as_tensor(mel, dtype=torch.float32, device=self.device)
        if m.dim() == 2:
            m = m[None]
        B, Tc, _ = m.shape
        schedule = diffusion.make_inference_schedule(self.hp, N)
        wav = diffusion.reverse_sample(
            lambda x, ts: self.model(x, m, ts), (B, Tc * self.cfg.hop_length), schedule,
            x_T=x_T, noises=noises, device=self.device)
        peak = wav.abs().amax(dim=-1, keepdim=True)
        return wav / torch.clamp(peak, min=1e-9)

"""HiFi-GAN V1 generator: mel (B, T, 80) -> waveform (B, T * 256).

Counterpart of ``lightningfastspeech2_tpu/vocoder/hifigan.py``
(``Generator`` and its fused-kernel path ``generator_apply_fused``):
conv_pre(7) -> 4 x [leaky(0.1) -> ConvTranspose1d upsample -> the stage's
ResBlock1s, averaged] -> leaky(0.01) -> conv_post(7) -> tanh.

Every resblock group goes through ``ops.hifigan_resblock``: stages of at
most 128 channels through ``resblock_trio`` (one launch for the three
ResBlock1s), wider stages (V1's 256-channel first one, and past 256 the
wide route's stages, 512 at ``upsample_initial_channel`` 1024) through
three ``resblock`` launches; on the card these are the CUDA kernels, on
the CPU their plain versions. conv_pre, the upsampling convs and conv_post are
``F.conv1d``/``F.conv_transpose1d``, as the JAX package left them to XLA.

A stage whose width the kernels are not built for (``upsample_initial_channel``
384 gives 192, 96, 48, 24) runs at the next width they are
(``kernel_channels``: 256, 128, 64, 32; past 256 the next multiple of
128, so 640 gives 320 run at 384): ``prepare()`` zero-pads the
output channels of the stage's upsampling conv and the input channels of
the conv after it (the next upsampling conv, or conv_post), so the
stage's signal carries the padded width from the conv that makes it, and
no signal is padded on the way. The padded channels stay exactly 0.

A config with ``resblock: "2"`` (HiFi-GAN V3's block) builds ``ResBlock2``
instead: two (leaky ReLU, dilated conv) residual steps in plain
``F.conv1d``, which the JAX package also runs outside its kernels.

Training takes ``forward(mel, train_route=True)``: each ResBlock1 computes
from its own ``nn.Conv1d`` parameters in plain ``F.conv1d``, with the
kernels' numerics, as the JAX trainer differentiates ``Generator.apply``
outside any Pallas kernel (the JAX package has no resblock backward
kernel, and the port has none). The serving route reads the tap stacks
that ``prepare()`` builds from the parameters; after optimizer steps they
are stale, so whatever serves a generator being trained calls
``prepare()`` first.

Parameters are named like the released torch checkpoints (``conv_pre``,
``ups.{i}``, ``resblocks.{rb}.convs1.{j}``, ResBlock2's
``resblocks.{rb}.convs.{j}``) with weight norm folded
(``fold_weight_norm``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lightningfastspeech2_tpu_torch.core.device import DeviceLike, resolve_device
from lightningfastspeech2_tpu_torch.ops.hifigan_resblock import (
    LRELU_SLOPE,
    ResblockWeights,
    kernel_channels,
    prepare_resblock_weights,
    resblock,
    resblock_trio,
)

# stages with at most this many channels run all their resblocks in one
# resblock_trio launch (the JAX package's rule: fold * C <= 128)
TRIO_MAX_CHANNELS = 128


@dataclass(frozen=True)
class HifiGanConfig:
    resblock: str = "1"
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5)
    )
    num_mels: int = 80
    sampling_rate: int = 22050

    @property
    def hop_length(self) -> int:
        out = 1
        for r in self.upsample_rates:
            out *= r
        return out

    @classmethod
    def from_dict(cls, d) -> "HifiGanConfig":
        """From ``dataclasses.asdict`` of either package's config, as a
        vocoder checkpoint's sidecar holds it (``hifigan_config``)."""
        return cls(
            resblock=d["resblock"],
            upsample_rates=tuple(d["upsample_rates"]),
            upsample_kernel_sizes=tuple(d["upsample_kernel_sizes"]),
            upsample_initial_channel=d["upsample_initial_channel"],
            resblock_kernel_sizes=tuple(d["resblock_kernel_sizes"]),
            resblock_dilation_sizes=tuple(tuple(x) for x in d["resblock_dilation_sizes"]),
            num_mels=d["num_mels"],
            sampling_rate=d["sampling_rate"],
        )


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def fold_weight_norm(weight_g, weight_v):
    """torch weight_norm(dim=0): w = g * v / ||v|| with the norm over every
    dim but 0. numpy or torch in, the same type out."""
    if isinstance(weight_v, torch.Tensor):
        norm = weight_v.flatten(1).norm(dim=1).reshape(-1, *[1] * (weight_v.dim() - 1))
        return weight_g * weight_v / torch.clamp(norm, min=1e-12)
    v, g = np.asarray(weight_v), np.asarray(weight_g)
    norm = np.sqrt(np.sum(v ** 2, axis=tuple(range(1, v.ndim)), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def fold_weight_norm_state(state: Dict[str, object]) -> Dict[str, object]:
    """A state dict with every ``weight_g``/``weight_v`` pair (released
    checkpoints) replaced by its folded ``weight``."""
    out = {k: v for k, v in state.items()
           if not k.endswith((".weight_g", ".weight_v"))}
    for k in state:
        if k.endswith(".weight_v"):
            prefix = k[: -len(".weight_v")]
            out[f"{prefix}.weight"] = fold_weight_norm(
                state[f"{prefix}.weight_g"], state[k])
    return out


def load_torch_generator(path, cfg: HifiGanConfig = HifiGanConfig()) -> Dict[str, torch.Tensor]:
    """A released torch HiFi-GAN generator checkpoint (the
    ``generator_universal.pth.tar`` layout, optionally nested under a
    ``"generator"`` key) as this module's state dict, weight norm folded.
    Only tensors are read (``weights_only``)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "generator" in state:
        state = state["generator"]
    state = fold_weight_norm_state(dict(state))
    n_blocks = len(cfg.upsample_rates) * len(cfg.resblock_kernel_sizes)
    first = "convs1.0" if cfg.resblock == "1" else "convs.0"
    missing = [k for k in ("conv_pre.weight", "conv_post.weight",
                           f"resblocks.{n_blocks - 1}.{first}.weight") if k not in state]
    if missing:
        raise ValueError(f"{path} is not a HiFi-GAN generator for {cfg}: no {missing}")
    return state


class ResBlock1(nn.Module):
    """Parameter holder: three (dilated conv, conv) residual pairs."""

    def __init__(self, channels: int, kernel_size: int, dilations: Tuple[int, ...]):
        super().__init__()
        self.kernel_size, self.dilations = kernel_size, tuple(dilations)
        self.convs1 = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=get_padding(kernel_size, d)) for d in dilations])
        self.convs2 = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, padding=get_padding(kernel_size))
            for _ in dilations])

    def spec(self):
        return (self.kernel_size, self.dilations,
                [(c1.weight, c1.bias, c2.weight, c2.bias)
                 for c1, c2 in zip(self.convs1, self.convs2)])

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The training route on x (B, C, L) in the working dtype ``dtype``,
        with the numerics of ``ops/hifigan_resblock.py resblock_plain``:
        leaky on the working dtype, f32 convs on weights rounded through
        it, bias and the second leaky in f32, a cast before the second conv
        and before the residual add (all no-ops in f32)."""
        for c1, c2 in zip(self.convs1, self.convs2):
            t = F.conv1d(F.leaky_relu(x, LRELU_SLOPE).float(), c1.weight.to(dtype).float(),
                         c1.bias.float(), padding=c1.padding, dilation=c1.dilation)
            t = F.leaky_relu(t, LRELU_SLOPE).to(dtype)
            t = F.conv1d(t.float(), c2.weight.to(dtype).float(), c2.bias.float(),
                         padding=c2.padding)
            x = x + t.to(dtype)
        return x


class ResBlock2(nn.Module):
    """Two (leaky ReLU, dilated conv) residual steps: HiFi-GAN's second
    residual block (``resblock: "2"``), in plain ``F.conv1d``, as the JAX
    package runs it outside its kernels."""

    def __init__(self, channels: int, kernel_size: int, dilations: Tuple[int, ...] = (1, 3)):
        super().__init__()
        self.convs = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=get_padding(kernel_size, d)) for d in dilations])

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """x (B, C, L) in the working dtype ``dtype``."""
        for c in self.convs:
            xt = F.conv1d(F.leaky_relu(x, LRELU_SLOPE), c.weight.to(dtype), c.bias.to(dtype),
                          padding=c.padding, dilation=c.dilation)
            x = x + xt
        return x


class Generator(nn.Module):
    def __init__(self, cfg: HifiGanConfig = HifiGanConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.resblock not in ("1", "2"):
            raise ValueError(f"resblock must be \"1\" or \"2\", got {cfg.resblock!r}")
        self.cfg, self.dtype = cfg, dtype
        block = ResBlock1 if cfg.resblock == "1" else ResBlock2
        c = cfg
        self.conv_pre = nn.Conv1d(c.num_mels, c.upsample_initial_channel, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (rate, k_up) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
            # the previous stage's width (not 2 ch, which an odd width breaks)
            ch_in, ch = (c.upsample_initial_channel // 2 ** j for j in (i, i + 1))
            self.ups.append(nn.ConvTranspose1d(ch_in, ch, k_up, rate,
                                               padding=(k_up - rate) // 2))
            for k, ds in zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes):
                self.resblocks.append(block(ch, k, tuple(ds)))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)
        self.stage_weights: List[List[ResblockWeights]] = []
        # the serving route's (weight, bias) of each upsampling conv and of
        # conv_post where a stage is padded, else None (the parameters)
        self.serve_convs: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None
        self.prepare()
        self.register_load_state_dict_post_hook(lambda m, _keys: m.prepare())

    def prepare(self) -> None:
        """(Re)build the resblock tap stacks: per stage one trio stack, or
        one stack per resblock for stages above TRIO_MAX_CHANNELS, and the
        padded serving convs where a stage is padded. ResBlock2 stages have
        none: they run plain convs."""
        n = len(self.cfg.resblock_kernel_sizes)
        self.stage_weights, self.serve_convs = [], None
        if self.cfg.resblock != "1":
            return
        widths = [kernel_channels(up.out_channels) for up in self.ups]
        if any(P != up.out_channels for P, up in zip(widths, self.ups)):
            self.serve_convs = self._padded_convs(widths)
        for i in range(len(self.ups)):
            blocks = [rb.spec() for rb in self.resblocks[i * n:(i + 1) * n]]
            if self.ups[i].out_channels <= TRIO_MAX_CHANNELS:
                self.stage_weights.append(
                    [prepare_resblock_weights(blocks, self.dtype)])
            else:
                self.stage_weights.append(
                    [prepare_resblock_weights([b], self.dtype) for b in blocks])

    @torch.no_grad()
    def _padded_convs(self, widths: List[int]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Each upsampling conv with its output channels zero-padded to its
        stage's width and its input channels to the previous stage's, then
        conv_post with its input channels padded to the last stage's."""
        out, prev = [], self.cfg.upsample_initial_channel
        for up, P in zip(self.ups, widths):
            w = up.weight                                     # (in, out, k)
            w = F.pad(w, (0, 0, 0, P - w.shape[1], 0, prev - w.shape[0]))
            out.append((w, F.pad(up.bias, (0, P - up.bias.shape[0]))))
            prev = P
        w = self.conv_post.weight                             # (1, in, 7)
        out.append((F.pad(w, (0, 0, 0, prev - w.shape[1])), self.conv_post.bias))
        return out

    def _apply(self, fn, *args, **kwargs):
        out = super()._apply(fn, *args, **kwargs)
        if self.stage_weights:
            self.prepare()
        return out

    def _conv(self, x: torch.Tensor, conv: nn.Module,
              wb: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        """x (B, C, L) in the working dtype through conv (transposed or
        not), with the weight and bias ``wb`` in place of its own where
        given."""
        dt = self.dtype
        w, b = wb or (conv.weight, conv.bias)
        w, b = w.to(dt), b.to(dt)
        if isinstance(conv, nn.ConvTranspose1d):
            return F.conv_transpose1d(x, w, b, conv.stride, conv.padding)
        return F.conv1d(x, w, b, padding=conv.padding)

    def forward(self, mel: torch.Tensor, train_route: bool = False) -> torch.Tensor:
        """mel (B, T, num_mels) -> waveform (B, T * hop). ``train_route``:
        the resblocks from their live parameters in plain ``F.conv1d``
        (differentiable); else from the prepared taps through
        ``ops.hifigan_resblock`` (the kernels on the card, which raise where
        a gradient is needed), each stage at its padded width."""
        x = self._conv(mel.to(self.dtype).transpose(1, 2), self.conv_pre)
        if self.cfg.resblock != "1" or train_route:
            return self._forward_plain(x)
        convs = self.serve_convs or [None] * (len(self.ups) + 1)
        for up, stage, wb in zip(self.ups, self.stage_weights, convs):
            x = self._conv(F.leaky_relu(x, LRELU_SLOPE), up, wb)
            xt = x.transpose(1, 2).contiguous()          # (B, L, C) for the kernels
            if len(stage) == 1:
                xt = resblock_trio(xt, stage[0])
            else:
                acc = None
                for w in stage:
                    y = resblock(xt, w)
                    acc = y if acc is None else acc + y
                xt = acc / float(len(stage))
            x = xt.transpose(1, 2)
        return self._post(x, convs[-1])

    def _forward_plain(self, x: torch.Tensor) -> torch.Tensor:
        """Every stage's resblocks as their modules compute them, averaged
        in the working dtype (ResBlock2, and ResBlock1's training route)."""
        n = len(self.cfg.resblock_kernel_sizes)
        for i, up in enumerate(self.ups):
            x = self._conv(F.leaky_relu(x, LRELU_SLOPE), up)
            x = sum(rb(x, self.dtype) for rb in self.resblocks[i * n:(i + 1) * n]) / float(n)
        return self._post(x)

    def _post(self, x: torch.Tensor,
              wb: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        # reference models.py:161 uses F.leaky_relu's default slope here
        x = self._conv(F.leaky_relu(x, 0.01), self.conv_post, wb)
        return torch.tanh(x)[:, 0, :]


@torch.no_grad()
def init_generator_weights(gen: Generator, generator: torch.Generator) -> None:
    """The JAX package's init: N(0, 0.01) kernels, zero biases."""
    for m in gen.modules():
        if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * 0.01)
            m.bias.zero_()
    gen.prepare()


class Synthesiser:
    """Inference wrapper: mel (T, 80) or (B, T, 80) as numpy -> waveform
    scaled by 32768, float32 numpy, shape (B, T * hop)."""

    def __init__(self, cfg: HifiGanConfig = HifiGanConfig(),
                 state_dict: Optional[Dict[str, object]] = None,
                 dtype: torch.dtype = torch.float32, device: DeviceLike = None,
                 seed: int = 0):
        dev = resolve_device(device)
        self.cfg = cfg
        self.model = Generator(cfg, dtype)
        if state_dict is not None:
            self.model.load_state_dict({k: torch.as_tensor(v) for k, v in
                                        fold_weight_norm_state(state_dict).items()})
        else:
            init_generator_weights(self.model, torch.Generator().manual_seed(seed))
        self.model.to(dev).eval()
        self.device = dev

    @torch.no_grad()
    def __call__(self, mel) -> np.ndarray:
        m = torch.as_tensor(np.asarray(mel, np.float32), device=self.device)
        if m.dim() == 2:
            m = m[None]
        wav = self.model(m)
        return (wav.float() * 32768.0).cpu().numpy().astype(np.float32)

"""HiFi-GAN adversarial training: the discriminators, the losses and the
trainer.

Counterpart of ``lightningfastspeech2_tpu/vocoder/hifigan_train.py``, the
published recipe (Kong et al. 2020):

- ``MultiPeriodDiscriminator``: period-p sub-discriminators (2, 3, 5, 7,
  11) over (T/p, p)-folded waveforms with strided tall convolutions;
- ``MultiScaleDiscriminator``: 3 scales (raw, /2, /4 average-pooled) of
  grouped 1-D conv stacks;
- LSGAN adversarial losses, feature matching (x2) and mel-spectrogram L1
  (x45) through the port's mel front end (``audio/mel.py``), with its
  gradient;
- AdamW (0.8, 0.99) with optax's defaults (eps 1e-8, weight decay 1e-4)
  and an exponential decay of the learning rate per update.

The discriminators are ``nn.Module``s in PyTorch's layouts: a period
discriminator sees (B, 1, T/p, p), a scale discriminator (B, 1, T); their
feature maps are the JAX package's transposed (NCHW and NCL for NHWC and
NWC), which neither loss sees. Their convolutions are cuDNN's, as the JAX
package leaves them to XLA outside any Pallas kernel. The generator trains
on its training route (``Generator.forward(mel, train_route=True)``): the
resblock kernels have no backward. Neither package has a spectral norm.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lightningfastspeech2_tpu_torch.audio.mel import mel_spectrogram
from lightningfastspeech2_tpu_torch.core.config import AudioConfig
from lightningfastspeech2_tpu_torch.core.device import DeviceLike, resolve_device
from lightningfastspeech2_tpu_torch.vocoder.hifigan import (
    LRELU_SLOPE,
    Generator,
    HifiGanConfig,
    init_generator_weights,
)

# optax.adamw's default weight decay (torch.optim.AdamW's is 0.01)
WEIGHT_DECAY = 1e-4
ADAM_EPS = 1e-8

Outs = List[torch.Tensor]
Feats = List[List[torch.Tensor]]


class PeriodDiscriminator(nn.Module):
    """wav (B, T) -> (logits (B, T'/p-ish), 6 feature maps). A T that is
    not a multiple of p is reflect-padded to one first."""

    CHANNELS = (32, 128, 512, 1024)

    def __init__(self, period: int):
        super().__init__()
        self.period = period
        convs, cin = [], 1
        for ch in self.CHANNELS:
            convs.append(nn.Conv2d(cin, ch, (5, 1), (3, 1), padding=(2, 0)))
            cin = ch
        convs.append(nn.Conv2d(cin, 1024, (5, 1), padding=(2, 0)))
        self.convs = nn.ModuleList(convs)
        self.conv_post = nn.Conv2d(1024, 1, (3, 1), padding=(1, 0))

    def forward(self, wav: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        B, T = wav.shape
        p = self.period
        pad = (p - T % p) % p
        x = wav[:, None]
        if pad:
            x = F.pad(x, (0, pad), mode="reflect" if T > 1 else "constant")
        x = x.reshape(B, 1, -1, p)
        feats = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            feats.append(x)
        x = self.conv_post(x)
        feats.append(x)
        return x.flatten(1), feats


class ScaleDiscriminator(nn.Module):
    """wav (B, T) -> (logits (B, T/16-ish), 8 feature maps): seven grouped
    conv layers and conv_post."""

    SPEC = ((128, 15, 1, 1), (128, 41, 2, 4), (256, 41, 2, 16), (512, 41, 4, 16),
            (1024, 41, 4, 16), (1024, 41, 1, 16), (1024, 5, 1, 1))  # (channels, k, stride, groups)

    def __init__(self):
        super().__init__()
        convs, cin = [], 1
        for ch, k, s, g in self.SPEC:
            convs.append(nn.Conv1d(cin, ch, k, s, padding=k // 2, groups=min(g, cin)))
            cin = ch
        self.convs = nn.ModuleList(convs)
        self.conv_post = nn.Conv1d(cin, 1, 3, padding=1)

    def forward(self, wav: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        x = wav[:, None]
        feats = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            feats.append(x)
        x = self.conv_post(x)
        feats.append(x)
        return x[:, 0], feats


def _avg_pool(wav: torch.Tensor) -> torch.Tensor:
    """(B, T) -> (B, T // 2 + 1): window 4, stride 2, 2 zeros each side,
    every window divided by 4 (flax's ``avg_pool`` counts the padding)."""
    return F.avg_pool1d(wav[:, None], 4, 2, padding=2, count_include_pad=True)[:, 0]


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11)):
        super().__init__()
        self.periods = tuple(periods)
        self.discs = nn.ModuleDict({f"period{p}": PeriodDiscriminator(p) for p in self.periods})

    def forward(self, wav: torch.Tensor) -> Tuple[Outs, Feats]:
        outs, feats = [], []
        for d in self.discs.values():
            o, f = d(wav)
            outs.append(o)
            feats.append(f)
        return outs, feats


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, n_scales: int = 3):
        super().__init__()
        self.discs = nn.ModuleDict({f"scale{i}": ScaleDiscriminator() for i in range(n_scales)})

    def forward(self, wav: torch.Tensor) -> Tuple[Outs, Feats]:
        outs, feats = [], []
        x = wav
        for i, d in enumerate(self.discs.values()):
            o, f = d(x)
            outs.append(o)
            feats.append(f)
            if i < len(self.discs) - 1:
                x = _avg_pool(x)
        return outs, feats


class Discriminators(nn.Module):
    """MPD then MSD: wav (B, T) -> (8 logits, 8 feature lists), in the JAX
    order. Built on ``device`` (``cuda`` unless the caller asks for the
    CPU)."""

    def __init__(self, device: DeviceLike = None):
        super().__init__()
        self.mpd = MultiPeriodDiscriminator()
        self.msd = MultiScaleDiscriminator()
        self.to(resolve_device(device))

    def forward(self, wav: torch.Tensor) -> Tuple[Outs, Feats]:
        po, pf = self.mpd(wav)
        so, sf = self.msd(wav)
        return po + so, pf + sf


# ---------------------------------------------------------------------------
# losses (Kong et al. 2020, eqs. 1-3)
# ---------------------------------------------------------------------------

def discriminator_loss(real_outs: Outs, fake_outs: Outs) -> torch.Tensor:
    loss = 0.0
    for r, f in zip(real_outs, fake_outs):
        loss = loss + torch.mean((r - 1.0) ** 2) + torch.mean(f ** 2)
    return loss


def generator_adv_loss(fake_outs: Outs) -> torch.Tensor:
    loss = 0.0
    for f in fake_outs:
        loss = loss + torch.mean((f - 1.0) ** 2)
    return loss


def feature_matching_loss(real_feats: Feats, fake_feats: Feats) -> torch.Tensor:
    loss = 0.0
    for rf, ff in zip(real_feats, fake_feats):
        for r, f in zip(rf, ff):
            loss = loss + torch.mean(torch.abs(r - f))
    return loss


def mel_l1_loss(wav_pred: torch.Tensor, wav_true: torch.Tensor,
                audio_cfg: AudioConfig) -> torch.Tensor:
    """Mean |log-mel(pred) - log-mel(true)| over (B, T, n_mels), the
    front end batched over B."""
    return torch.mean(torch.abs(mel_spectrogram(wav_pred, audio_cfg)
                                - mel_spectrogram(wav_true, audio_cfg)))


@dataclass(frozen=True)
class HifiGanTrainConfig:
    lr: float = 2e-4
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    lr_decay: float = 0.999
    mel_weight: float = 45.0
    fm_weight: float = 2.0


def make_optimizer(params, cfg: HifiGanTrainConfig) -> torch.optim.AdamW:
    """optax.adamw(exponential_decay(lr, 1, lr_decay), b1, b2): eps 1e-8,
    weight decay 1e-4 on every parameter (``scheduled_lr`` sets the rate
    before each update)."""
    return torch.optim.AdamW(params, lr=cfg.lr, betas=(cfg.adam_b1, cfg.adam_b2),
                             eps=ADAM_EPS, weight_decay=WEIGHT_DECAY)


def optimizer_count(opt: torch.optim.Optimizer) -> int:
    """The updates ``opt`` has made: its state's step count (a CPU tensor,
    so reading it waits for nothing on the card)."""
    for group in opt.param_groups:
        for p in group["params"]:
            state = opt.state.get(p)
            if state and "step" in state:
                return int(state["step"])
    return 0


def scheduled_lr(opt: torch.optim.Optimizer, cfg: HifiGanTrainConfig) -> float:
    """Set and return lr * lr_decay ** count, count the updates made so far
    (``optax.exponential_decay(lr, 1, lr_decay)``)."""
    lr = cfg.lr * cfg.lr_decay ** optimizer_count(opt)
    for group in opt.param_groups:
        group["lr"] = lr
    return lr


class HifiGanTrainer:
    """Alternating discriminator and generator updates, as the JAX
    ``HifiGanTrainer.train_step``: D from the real and the generated
    waveform, then G against the updated D (LSGAN, feature matching, mel
    L1). The generator and the discriminators are f32 on ``device``
    (``cuda`` unless the caller asks for the CPU), seeded from ``seed`` with
    the JAX package's distributions (its draws cannot be reproduced)."""

    def __init__(self, gen_cfg: HifiGanConfig = HifiGanConfig(),
                 train_cfg: HifiGanTrainConfig = HifiGanTrainConfig(),
                 audio_cfg: AudioConfig = AudioConfig(), device: DeviceLike = None,
                 seed: int = 0):
        from lightningfastspeech2_tpu_torch.utils.convert import init_discriminator_weights

        dev = resolve_device(device)
        self.gen_cfg, self.train_cfg, self.audio_cfg, self.device = (
            gen_cfg, train_cfg, audio_cfg, dev)
        g = torch.Generator().manual_seed(seed)
        self.generator = Generator(gen_cfg)
        init_generator_weights(self.generator, g)
        self.generator.to(dev)
        self.discriminators = Discriminators(device="cpu")
        init_discriminator_weights(self.discriminators, g)
        self.discriminators.to(dev)
        self.gen_opt = make_optimizer(self.generator.parameters(), train_cfg)
        self.disc_opt = make_optimizer(self.discriminators.parameters(), train_cfg)

    def train_step(self, mel: torch.Tensor, wav: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One D and one G update on mel (B, T, num_mels) and wav (B, T *
        hop). Returns the losses as device scalars: nothing is read back to
        the host (the CLI converts them only when it logs)."""
        gen, disc, cfg = self.generator, self.discriminators, self.train_cfg
        # The generator is deterministic, so the JAX step's two forwards
        # give one waveform: it is computed once, and D sees it detached.
        fake = gen(mel, train_route=True)

        real_outs, _ = disc(wav)
        fake_outs, _ = disc(fake.detach())
        d_loss = discriminator_loss(real_outs, fake_outs)
        scheduled_lr(self.disc_opt, cfg)
        self.disc_opt.zero_grad(set_to_none=True)
        d_loss.backward()
        self.disc_opt.step()

        fake_outs, fake_feats = disc(fake)
        with torch.no_grad():
            _, real_feats = disc(wav)
        adv = generator_adv_loss(fake_outs)
        fm = feature_matching_loss(real_feats, fake_feats)
        mel_l1 = mel_l1_loss(fake, wav, self.audio_cfg)
        g_loss = adv + cfg.fm_weight * fm + cfg.mel_weight * mel_l1
        scheduled_lr(self.gen_opt, cfg)
        self.gen_opt.zero_grad(set_to_none=True)
        # only the generator's gradients (D's weight gradients are not formed)
        g_loss.backward(inputs=list(gen.parameters()))
        self.gen_opt.step()
        return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(), "adv": adv.detach(),
                "fm": fm.detach(), "mel": mel_l1.detach()}

    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """``{"gen", "disc"}`` state dicts, the names a vocoder checkpoint
        holds (``cli/generate.py --hifigan_checkpoint`` reads ``gen``)."""
        return {"gen": self.generator.state_dict(), "disc": self.discriminators.state_dict()}

    def opt_state(self) -> Dict[str, dict]:
        return {"gen": self.gen_opt.state_dict(), "disc": self.disc_opt.state_dict()}

    def load(self, params: Dict[str, dict], opt_state: Dict[str, dict] = None) -> None:
        """Weights (and the optimizers' states, step counts included) as
        ``params`` / ``opt_state`` give them (a JAX run's through
        ``utils/convert.py adamw_state_from_optax``). The hyperparameters
        stay this trainer's, as the JAX CLI's come from its flags."""
        self.generator.load_state_dict({k: torch.as_tensor(v) for k, v in params["gen"].items()})
        self.discriminators.load_state_dict(
            {k: torch.as_tensor(v) for k, v in params["disc"].items()})
        if opt_state is not None:
            for opt, name in ((self.gen_opt, "gen"), (self.disc_opt, "disc")):
                own = [{k: v for k, v in g.items() if k != "params"} for g in opt.param_groups]
                opt.load_state_dict(opt_state[name])
                for group, hyper in zip(opt.param_groups, own):
                    group.update(hyper)

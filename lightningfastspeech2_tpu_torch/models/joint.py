"""Joint acoustic-model + FastDiff-vocoder training, and the acoustic
model's FastDiff-vocoder knobs.

Counterpart of ``lightningfastspeech2_tpu/models/joint.py`` (reference
``fastspeech2.py:390-411,733-765``): the acoustic model emits the mel and a
x0.1 residual correction head; the vocoder conditions on the predicted mel
(+ residual) or the ground-truth mel (+ residual), one Bernoulli draw a step
against the epoch-indexed ``schedule_probability``; the waveform (int16
transfers dequantized) is cut to (frames - 2) * hop and masked by each
item's mel length; the vocoder predicts ε for the joint MSE loss
(``loss.py:192-198``) through FastDiff's training route (``FastDiff.forward(
..., train_route=True)``, the JAX package's ``FastDiff.apply``).

Checkpoints hold the joint weights as ``{"acoustic": ..., "fastdiff": ...}``,
the layout the JAX package writes and the generate CLI serves
(``nest_joint`` / ``flatten_joint``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from lightningfastspeech2_tpu_torch.core.config import ModelConfig
from lightningfastspeech2_tpu_torch.core.device import DeviceLike, resolve_device
from lightningfastspeech2_tpu_torch.data.wav import dequantize
from lightningfastspeech2_tpu_torch.models.draws import Draws, ModuleStreams
from lightningfastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
from lightningfastspeech2_tpu_torch.models.variance_adaptor import StatsTree
from lightningfastspeech2_tpu_torch.vocoder import diffusion
from lightningfastspeech2_tpu_torch.vocoder.fastdiff import (
    FastDiff,
    FastDiffConfig,
    init_fastdiff_weights,
)

JOINT_PARTS = ("acoustic", "fastdiff")


class JointFastSpeech2FastDiff(nn.Module):
    """``acoustic`` (FastSpeech2 with the residual head) and ``fastdiff``.
    In training (``inference=False`` with a ``wav`` in the batch) the result
    gains ``fastdiff`` = (ε prediction, z), both 0 outside ``wav_mask``."""

    name = "joint"   # its draws' stream

    def __init__(self, cfg: ModelConfig, fastdiff_cfg: FastDiffConfig,
                 stats: StatsTree = (), prior_stats: StatsTree = (),
                 dtype: torch.dtype = torch.float32, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.cfg, self.fastdiff_cfg, self.dtype = cfg, fastdiff_cfg, dtype
        self.acoustic = FastSpeech2(cfg, stats, prior_stats, dtype, "cpu", g,
                                    use_fastdiff_head=True)
        self.fastdiff = FastDiff(fastdiff_cfg, dtype)
        init_fastdiff_weights(self.fastdiff, g)
        hp = diffusion.compute_hyperparams(diffusion.linear_beta_schedule(
            fastdiff_cfg.beta_0, fastdiff_cfg.beta_T, fastdiff_cfg.T))
        self.diffusion_T = hp.T
        self.register_buffer("alpha", torch.from_numpy(np.asarray(hp.alpha, np.float32)),
                             persistent=False)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.acoustic.device

    @property
    def stats(self):
        return self.acoustic.stats

    def forward(self, batch: Dict[str, torch.Tensor], inference: bool = False,
                tf: bool = True, schedule_p: float = 1.0,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Draws] = None, **acoustic_kwargs) -> Dict[str, Any]:
        draws = draws if draws is not None else ModuleStreams(0)
        result = self.acoustic(batch, inference=inference, tf=tf, generator=generator,
                               draws=draws, **acoustic_kwargs)
        if inference or "wav" not in batch or acoustic_kwargs.get("duration_only"):
            return result

        hop = self.fastdiff_cfg.hop_length
        frame_mask = result["frame_mask"]
        mel_pred = result["mel"] + result["fastdiff_var"]
        mel_gt = batch["mel"][:, : mel_pred.shape[1]] + result["fastdiff_var"]
        use_pred = draws.uniform(self.name, (), mel_pred.device) < schedule_p
        mel_cond = torch.where(use_pred, mel_pred, mel_gt)

        # cut to the batch's longest mel length - 2 (fastspeech2.py:748)
        T = mel_cond.shape[1] - 2
        mel_cond = mel_cond[:, :T]
        wav = dequantize(batch["wav"])[:, : T * hop]
        mel_lengths = frame_mask.sum(1)
        wav_mask = (torch.arange(T * hop, device=wav.device)[None, :]
                    < ((mel_lengths - 2) * hop)[:, None])

        # the ε-prediction training draw (FastDiff.py:104-143)
        B = wav.shape[0]
        ts = draws.randint(self.name, (B,), self.diffusion_T, wav.device)
        z = draws.normal(self.name, tuple(wav.shape), wav.device)
        noisy = diffusion.diffuse(wav, ts, z, self.alpha)
        eps = self.fastdiff(noisy, mel_cond, ts.float(), train_route=True)
        zero = torch.zeros((), dtype=eps.dtype, device=eps.device)
        eps = torch.where(wav_mask, eps, zero)
        z = torch.where(wav_mask, z, torch.zeros((), dtype=z.dtype, device=z.device))
        result["fastdiff"] = (eps, z)
        result["wav_mask"] = wav_mask
        return result


def nest_joint(params: Mapping[str, Any]) -> Dict[str, Any]:
    """A joint model's flat state dict (``acoustic.*``, ``fastdiff.*``) as
    ``{"acoustic": ..., "fastdiff": ...}``; any other state dict as it is."""
    if not any(k.startswith("acoustic.") for k in params):
        return dict(params)
    out: Dict[str, Dict[str, Any]] = {p: {} for p in JOINT_PARTS}
    for k, v in params.items():
        part, _, rest = k.partition(".")
        out[part][rest] = v
    return out


def flatten_joint(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of ``nest_joint``."""
    if not (set(tree) <= set(JOINT_PARTS) and isinstance(tree.get("acoustic"), Mapping)):
        return dict(tree)
    return {f"{part}.{k}": v for part in JOINT_PARTS for k, v in tree.get(part, {}).items()}


def make_fastdiff_config(cfg: ModelConfig) -> FastDiffConfig:
    """FastDiffConfig from the model config's vocoder knobs (reference
    ``FastDiff.py:217-255`` argparse defaults). The upsample ratios must
    multiply to the audio hop length so one mel frame conditions exactly
    ``hop`` waveform samples."""
    fd = FastDiffConfig(
        inner_channels=cfg.fastdiff_inner_channels,
        cond_channels=cfg.audio.n_mels,
        upsample_ratios=cfg.fastdiff_upsample_ratios,
        lvc_layers_each_block=cfg.fastdiff_lvc_layers,
        kpnet_hidden_channels=cfg.fastdiff_kpnet_hidden,
        T=cfg.fastdiff_diffusion_T,
    )
    if fd.hop_length != cfg.audio.hop_length:
        raise ValueError(
            f"fastdiff_upsample_ratios {cfg.fastdiff_upsample_ratios} "
            f"multiply to {fd.hop_length}, need audio hop "
            f"{cfg.audio.hop_length}"
        )
    return fd


def schedule_probability(cfg: ModelConfig, epoch: int) -> float:
    """Epoch-indexed mix probability (fastspeech2.py:403-411,737-743)."""
    sched = cfg.fastdiff_schedule
    idx = epoch if epoch < cfg.fastdiff_schedule_end else -1
    idx = min(idx, len(sched) - 1) if idx >= 0 else -1
    return float(sched[idx])

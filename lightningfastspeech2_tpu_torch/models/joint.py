"""The acoustic model's FastDiff-vocoder knobs.

Counterpart of the config helpers of ``lightningfastspeech2_tpu/models/
joint.py``: ``make_fastdiff_config`` (the vocoder's config from the model
config, with its hop check) and ``schedule_probability`` (the epoch-indexed
mix of predicted and ground-truth mels). The joint training module
(``JointFastSpeech2FastDiff``) and its ε-MSE loss are not ported yet.
"""

from __future__ import annotations

from lightningfastspeech2_tpu_torch.core.config import ModelConfig
from lightningfastspeech2_tpu_torch.vocoder.fastdiff import FastDiffConfig


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

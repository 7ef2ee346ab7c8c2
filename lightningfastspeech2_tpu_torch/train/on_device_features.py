"""On-device prosody extraction: raw waveforms in, features computed in the
train step on the batch's device.

Counterpart of ``lightningfastspeech2_tpu/train/on_device_features.py``.
With ``--on_device_features`` the host pipeline only decodes the wavs and
pads them to the frame bucket (``data/dataset.py`` raw mode); mel, energy,
YIN pitch, WADA SNR, SRMR, NaN interpolation, silence masking, phone
averaging, the CWT and normalization run here, once a (micro-)batch, under
``torch.no_grad()`` and in f32 whatever the model's working dtype, on the
device the batch lies on (the card's kernels need none of it: every step is
a PyTorch op). TF32 is off for the extraction and restored after
(``core/device.py tf32_off``): the mel's filterbank product is a cuBLAS
matmul, which a process with TF32 on would round to 10 bits; the CWT is an
FFT convolution, f32 either way.

The semantics follow the JAX function line by line, including its two
approximations of the host path: the SRMR's true sample count is taken as
frames x hop (raw batches carry no exact wav lengths), and its Hilbert
envelope spans the padded buffer (``audio/srmr.py frame_srmr_padded``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from lightningfastspeech2_tpu_torch.audio import cwt as cwt_mod
from lightningfastspeech2_tpu_torch.audio import features as feat
from lightningfastspeech2_tpu_torch.audio import mel as mel_mod
from lightningfastspeech2_tpu_torch.audio import pitch as pitch_mod
from lightningfastspeech2_tpu_torch.audio import snr as snr_mod
from lightningfastspeech2_tpu_torch.audio.srmr import frame_srmr_padded
from lightningfastspeech2_tpu_torch.core.config import Config
from lightningfastspeech2_tpu_torch.core.device import tf32_off
from lightningfastspeech2_tpu_torch.data.wav import dequantize
from lightningfastspeech2_tpu_torch.models.variance_adaptor import StatsTree
from lightningfastspeech2_tpu_torch.ops.length_regulator import regulate


def extract_batch_features(wav: torch.Tensor, durations: torch.Tensor,
                           silence_phone: torch.Tensor, cfg: Config, stats: StatsTree,
                           max_frames: int,
                           phones_lengths: Optional[torch.Tensor] = None
                           ) -> Dict[str, torch.Tensor]:
    """``wav`` (B, T * hop) padded audio, ``durations`` (B, P),
    ``silence_phone`` (B, P) True at a ``[..]`` token -> ``mel`` (B,
    max_frames, n_mels) and the ``variances_*`` targets the host pipeline
    gives (datasets.py:562-648), all on ``wav``'s device. ``phones_lengths``
    (B,) is needed by phone-level CWT variances only."""
    with torch.no_grad(), tf32_off():
        return _extract(wav, durations, silence_phone, cfg, stats, max_frames, phones_lengths)


def _extract(wav, durations, silence_phone, cfg, stats, max_frames, phones_lengths):
    a = cfg.model.audio
    vcfg = cfg.model.variance
    stats_map = dict(stats)
    wav = wav.float()

    raw = {"mel": mel_mod.mel_spectrogram(wav, a)[:, :max_frames]}
    if "pitch" in vcfg.variances:
        raw["pitch"] = pitch_mod.track(wav, a.sampling_rate, a.hop_length,
                                       a.win_length)[:, :max_frames]
    if "snr" in vcfg.variances:
        raw["snr"] = snr_mod.windowed_wada(wav, a.hop_length, a.win_length)[:, :max_frames]
    if "energy" in vcfg.variances:
        raw["energy"] = feat.frame_energy(wav, a.hop_length, a.win_length)[:, :max_frames]

    # phone-level silence expanded to the frame grid (TTSDataset._expand)
    silence_frames = regulate(silence_phone.float(), durations, max_frames)[0] > 0.5
    frame_lengths = torch.clamp(durations.to(torch.int64).sum(1), max=max_frames)

    if "srmr" in vcfg.variances:
        # the true sample count as frames x hop: a window more or less than
        # the host's at a hop boundary, as in the JAX package
        raw["srmr"] = frame_srmr_padded(wav, frame_lengths * a.hop_length, frame_lengths,
                                        max_frames, a.sampling_rate)

    result: Dict[str, torch.Tensor] = {"mel": raw["mel"]}
    for i, var in enumerate(vcfg.variances):
        sig = raw[var].float()
        if var == "pitch":
            sig = torch.where(sig == 0, torch.nan, sig)
            sig = torch.where(silence_frames, torch.nan, sig)
            all_nan = torch.isnan(sig).all(1, keepdim=True)
            sig = torch.where(all_nan, 1e-7, sig)
            sig = feat.interpolate_nans_t(sig)
        elif var == "snr":
            sig = torch.where(silence_frames, torch.nan, sig)
            all_nan = torch.isnan(sig).all(1, keepdim=True)
            sig = feat.interpolate_nans_t(sig)
            sig = torch.where(all_nan, 0.0, sig)
        if vcfg.levels[i] == "phone":
            sig = feat.phone_average_t(sig, durations, durations.shape[1])
            lengths = phones_lengths
        else:
            lengths = frame_lengths
        if vcfg.transforms[i] == "cwt":
            if lengths is None:
                raise ValueError("phone-level CWT on-device extraction needs phones_lengths "
                                 "(present in raw-mode batches)")
            lengths = lengths.to(device=sig.device, dtype=torch.int64)
            dec = cwt_mod.decompose_padded(sig, lengths)
            # the host keeps the cleaned linear signal (the model's teacher
            # path takes its log again); padding stays 0
            valid = torch.arange(sig.shape[1], device=sig.device) < lengths[:, None]
            result[f"variances_{var}_signal"] = torch.where(valid, torch.exp(dec["signal"]), 0.0)
            result[f"variances_{var}_spectrogram"] = dec["spectrogram"]
            result[f"variances_{var}_mean"] = dec["mean"]
            result[f"variances_{var}_std"] = dec["std"]
            continue
        if vcfg.transforms[i] == "log":
            sig = torch.log(torch.clamp(sig, min=1e-10))
        else:
            st = stats_map.get(var)
            if st is not None:
                # the statistics as f32 constants, as XLA folds them
                sig = (sig - float(np.float32(st.mean))) / float(np.float32(st.std))
        result[f"variances_{var}"] = sig
    return result


def augment_batch_with_features(batch: Mapping[str, Any], cfg: Config,
                                stats: StatsTree) -> Dict[str, Any]:
    """The batch with ``wav`` dequantized (an int16 transfer becomes f32 in
    [-1, 1)) and the feature tensors computed from it added. Needs ``wav``,
    ``duration`` and ``silence_phone``."""
    wav = dequantize(batch["wav"])
    max_frames = min(wav.shape[1] // cfg.model.audio.hop_length, cfg.model.max_frames)
    feats = extract_batch_features(wav, batch["duration"], batch["silence_phone"], cfg, stats,
                                   max_frames, phones_lengths=batch.get("phones_lengths"))
    out = dict(batch)
    out["wav"] = wav
    out.update(feats)
    return out


def maybe_on_device_features(model, cfg: Config, batch: Mapping[str, Any]) -> Mapping[str, Any]:
    """``augment_batch_with_features`` where the JAX step applies it:
    ``on_device_features`` on, a ``wav`` in the batch and no ``mel``."""
    if cfg.train.on_device_features and "wav" in batch and "mel" not in batch:
        return augment_batch_with_features(batch, cfg, model.stats)
    return batch

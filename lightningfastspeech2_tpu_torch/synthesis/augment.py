"""The port's own copy of ``lightningfastspeech2_tpu/synthesis/augment.py``.

Post-vocoder waveform augmentations.

Native replacements for the reference's audiomentations chain
(reference ``litfass/generate.py:48-104``, applied post-vocoder at
``generator.py:197-201``): PitchShift, AddGaussianSNR, RoomSimulator. The
audiomentations package is unavailable here; these are self-contained
numpy/scipy implementations with the same parameter surface (min/max ranges
and probabilities) and the same Compose semantics.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
from scipy.signal import fftconvolve

from lightningfastspeech2_tpu_torch.data.wav import resample


@dataclass
class PitchShift:
    """Resample-based pitch shift (changes pitch, keeps duration by
    time-stretching via overlap-add of the resampled signal)."""

    min_semitones: float = -4.0
    max_semitones: float = 4.0
    p: float = 0.5

    def __call__(self, wav: np.ndarray, sample_rate: int,
                 rng: np.random.Generator) -> np.ndarray:
        if rng.uniform() > self.p:
            return wav
        semitones = rng.uniform(self.min_semitones, self.max_semitones)
        factor = 2.0 ** (semitones / 12.0)
        # resample to shift pitch, then OLA time-stretch back to length
        shifted = resample(wav, sample_rate, int(round(sample_rate / factor)))
        return _ola_stretch(shifted, len(wav), sample_rate)


def _ola_stretch(wav: np.ndarray, target_len: int, sr: int,
                 frame_ms: float = 50.0) -> np.ndarray:
    """WSOLA-style time stretch to an exact length: each overlap position
    is cross-correlation-aligned against the running output so periodic
    signals stay phase-coherent (plain OLA leaves modulation sidebands)."""
    if len(wav) == target_len:
        return wav
    frame = int(sr * frame_ms / 1000)
    hop_out = frame // 2
    search = hop_out // 2
    n_frames = max(target_len // hop_out, 1)
    hop_in = max((len(wav) - frame - search) // max(n_frames - 1, 1), 1)
    window = np.hanning(frame).astype(np.float32)
    out = np.zeros(target_len + 2 * frame, np.float32)
    norm = np.zeros_like(out)

    for i in range(n_frames):
        s_out = i * hop_out
        s_nom = min(i * hop_in, max(len(wav) - frame, 0))
        if i == 0 or s_nom < search:
            s_in = s_nom
        else:
            # align the candidate frame's head with what's already written
            ref = out[s_out : s_out + hop_out]
            denom = np.maximum(norm[s_out : s_out + hop_out], 1e-6)
            ref = ref / denom
            best, best_score = s_nom, -np.inf
            for off in range(-search, search + 1, max(search // 16, 1)):
                s = s_nom + off
                if s < 0 or s + frame > len(wav):
                    continue
                score = float(np.dot(ref, wav[s : s + hop_out]))
                if score > best_score:
                    best, best_score = s, score
            s_in = best
        chunk = wav[s_in : s_in + frame]
        out[s_out : s_out + len(chunk)] += chunk * window[: len(chunk)]
        norm[s_out : s_out + len(chunk)] += window[: len(chunk)]
    out = out / np.maximum(norm, 1e-6)
    return out[:target_len].astype(np.float32)


@dataclass
class AddGaussianSNR:
    """White noise at a random SNR (audiomentations AddGaussianSNR)."""

    min_snr_db: float = 5.0
    max_snr_db: float = 40.0
    p: float = 0.5

    def __call__(self, wav, sample_rate, rng):
        if rng.uniform() > self.p:
            return wav
        snr_db = rng.uniform(self.min_snr_db, self.max_snr_db)
        signal_rms = np.sqrt(np.mean(wav**2) + 1e-12)
        noise_rms = signal_rms / (10 ** (snr_db / 20))
        return (wav + rng.standard_normal(len(wav)) * noise_rms).astype(
            np.float32
        )


@dataclass
class RoomSimulator:
    """Reverberation via a synthetic exponential-decay RIR (image-method
    lite; audiomentations RoomSimulator parameter surface)."""

    min_target_rt60: float = 0.15
    max_target_rt60: float = 0.8
    p: float = 0.5

    def __call__(self, wav, sample_rate, rng):
        if rng.uniform() > self.p:
            return wav
        rt60 = rng.uniform(self.min_target_rt60, self.max_target_rt60)
        n_ir = max(int(rt60 * sample_rate), 8)
        t = np.arange(n_ir) / sample_rate
        ir = rng.standard_normal(n_ir) * np.exp(-6.908 * t / rt60)
        ir[0] = 1.0  # direct path
        ir /= np.sqrt(np.sum(ir**2))
        out = fftconvolve(wav, ir)[: len(wav)]
        peak = np.max(np.abs(out))
        return (out / max(peak, 1e-9) * np.max(np.abs(wav))).astype(np.float32)


@dataclass
class Compose:
    transforms: List = field(default_factory=list)
    seed: Optional[int] = None

    def __call__(self, wav: np.ndarray, sample_rate: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        for t in self.transforms:
            wav = t(wav, sample_rate, rng)
        return wav


def from_args(pitch_shift=False, gaussian_snr=False, room=False,
              seed=None, **kwargs) -> Optional[Compose]:
    """CLI-flag assembly mirroring generate.py's reflected augmentation
    arguments; kwargs pass through to the matching transform by prefix,
    e.g. pitch_shift_min_semitones=-2."""
    transforms = []

    def collect(prefix, cls):
        params = {
            k[len(prefix) + 1 :]: v for k, v in kwargs.items()
            if k.startswith(prefix + "_")
        }
        return cls(**params)

    if pitch_shift:
        transforms.append(collect("pitch_shift", PitchShift))
    if gaussian_snr:
        transforms.append(collect("gaussian_snr", AddGaussianSNR))
    if room:
        transforms.append(collect("room", RoomSimulator))
    return Compose(transforms, seed=seed) if transforms else None

"""Mel-spectrogram front-end in PyTorch.

Counterpart of ``lightningfastspeech2_tpu/audio/mel.py`` (the reference's
torchaudio + librosa pipeline, ``litfass/dataset/datasets.py:184-199,
373-396``, ``litfass/dataset/audio_utils.py:8-12``):

- magnitude spectrogram: n_fft 1024, win 1024, hop 256, periodic Hann,
  power 1.0, centered with **constant** (zero) padding (``torch.stft``),
- linear->mel via the librosa Slaney-scale filterbank (htk=False,
  norm='slaney'),
- log10 dynamic-range compression with clip 1e-6,
- transposed to (T, n_mels).

The functions run on the device of the wav they are given. The filterbank
and the window are built lazily, once per process and device
(``mel_basis``, ``stft_window``), so nothing of them is pickled with a
dataset into a worker.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from lightningfastspeech2_tpu_torch.core.config import AudioConfig


def hann_window(win_length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window (torch.hann_window default periodic=True)."""
    n = torch.arange(win_length, dtype=dtype, device=device)
    return 0.5 * (1.0 - torch.cos(2.0 * math.pi * n / win_length))


# ---------------------------------------------------------------------------
# Slaney mel filterbank (librosa.filters.mel with htk=False, norm='slaney')
# ---------------------------------------------------------------------------

_F_SP = 200.0 / 3  # Hz per mel below the break frequency
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    mel = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    mel = np.where(
        log_region, _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP, mel
    )
    return mel


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    f = np.where(log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), f)
    return f


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    sampling_rate: int,
    n_fft: int,
    n_mels: int,
    f_min: float,
    f_max: float,
) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) Slaney-normalized triangular filterbank."""
    fft_freqs = np.linspace(0, sampling_rate / 2, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney area normalization
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=8)
def mel_filterbank_htk(
    sampling_rate: int,
    n_fft: int,
    n_mels: int,
    f_min: float,
    f_max: float,
) -> np.ndarray:
    """HTK-scale unnormalized triangular filterbank (torchaudio
    MelSpectrogram defaults: mel_scale='htk', norm=None), (n_mels, bins).
    Used by the d-vector front-end (third_party/dvectors/wav2mel.py)."""
    hz2mel = lambda f: 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)
    mel2hz = lambda m: 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)
    fft_freqs = np.linspace(0, sampling_rate / 2, 1 + n_fft // 2)
    hz_pts = mel2hz(np.linspace(hz2mel(f_min), hz2mel(f_max), n_mels + 2))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    return np.maximum(0.0, np.minimum(lower, upper)).astype(np.float32)


@functools.lru_cache(maxsize=16)
def mel_basis(sampling_rate: int, n_fft: int, n_mels: int, f_min: float, f_max: float,
              device: str) -> torch.Tensor:
    """``mel_filterbank`` transposed, (bins, n_mels) f32 on ``device``;
    built on first use in each process."""
    fb = mel_filterbank(sampling_rate, n_fft, n_mels, f_min, f_max)
    return torch.from_numpy(np.ascontiguousarray(fb.T)).to(device)


@functools.lru_cache(maxsize=16)
def stft_window(n_fft: int, win_length: int, device: str) -> torch.Tensor:
    """The periodic Hann window zero-centered in an n_fft frame, f32 on
    ``device``; built on first use in each process."""
    win = hann_window(win_length, device=device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        win = torch.nn.functional.pad(win, (lpad, n_fft - win_length - lpad))
    return win


# ---------------------------------------------------------------------------
# STFT magnitude
# ---------------------------------------------------------------------------

def spectrogram(
    wav: torch.Tensor,
    n_fft: int = 1024,
    win_length: int = 1024,
    hop_length: int = 256,
) -> torch.Tensor:
    """Power-1.0 (magnitude) spectrogram of a wav (..., N), (..., T,
    1 + n_fft//2), f32, T = 1 + N // hop; each row of a batch on its own.

    win_length == n_fft in the reference config; shorter windows are
    zero-centered inside the FFT frame, as torch.stft does."""
    wav = wav.to(torch.float32)
    lead = wav.shape[:-1]
    if wav.dim() > 2:  # torch.stft takes (N,) or (B, N)
        wav = wav.reshape(-1, wav.shape[-1])
    win = stft_window(n_fft, win_length, str(wav.device))
    spec = torch.stft(wav, n_fft, hop_length=hop_length, win_length=n_fft, window=win,
                      center=True, pad_mode="constant", return_complex=True)
    spec = spec.abs().transpose(-1, -2)
    return spec.reshape(lead + spec.shape[-2:])


def log_compress(x: torch.Tensor, clip_val: float = 1e-6, log10: bool = True,
                 C: float = 1.0) -> torch.Tensor:
    """Dynamic-range compression (audio_utils.py:8-12)."""
    clipped = torch.clamp(x, min=clip_val) * C
    return torch.log10(clipped) if log10 else torch.log(clipped)


def mel_spectrogram(wav: torch.Tensor, cfg: AudioConfig = AudioConfig()) -> torch.Tensor:
    """Full front-end: wav (..., N) -> log-mel (..., T, n_mels), T = 1 +
    N//hop."""
    spec = spectrogram(wav, cfg.n_fft, cfg.win_length, cfg.hop_length)
    basis = mel_basis(cfg.sampling_rate, cfg.n_fft, cfg.n_mels, cfg.f_min, cfg.f_max,
                      str(spec.device))
    mel = spec @ basis  # (T, n_mels)
    return log_compress(mel, cfg.clip_val, cfg.log10)


def normalize_wav(wav: torch.Tensor) -> torch.Tensor:
    """Peak normalization as done at load time (datasets.py:369)."""
    return wav / wav.abs().max()

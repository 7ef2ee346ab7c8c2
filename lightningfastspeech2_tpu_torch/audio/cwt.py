"""Continuous wavelet transform of prosody signals.

Counterpart of ``lightningfastspeech2_tpu/audio/cwt.py``: the reference
decomposes log-pitch into a 10-scale Ricker ("Mexican hat") CWT
spectrogram plus mean/std, and recomposes by summing scales and
re-normalizing (reference ``litfass/dataset/cwt.py``, after Suni et al.
SSW8 2.3). Scale widths are ``2**(i+1) * tau`` for i=1..10 with
tau=0.2833425, and each scale row is weighted by ``(i + 2.5)**(-5/2)``.

``decompose_np`` (the data pipeline's, numpy) is a copy, bit for bit;
``recompose`` (the model's inverse) runs in PyTorch. ``decompose_fixed_length``,
``decompose`` and ``decompose_padded`` are the on-device twins the train
step's feature extraction uses (``train/on_device_features.py``), for a
batch (B, T) at once: each item's Ricker kernel has its own length
(``min(10 width, length)``, scipy.signal.cwt's truncation), so every scale
holds B kernels in one static buffer, and the 'same'-mode convolution is a
full convolution through ``torch.fft`` (f32 whatever TF32 allows: cuDNN's
convolutions would run in TF32 in a bf16 process) cropped at each item's
own centre.
"""

from __future__ import annotations

import numpy as np
import torch

N_SCALES = 10
TAU = 0.2833425


def ricker(points: int, a: float) -> np.ndarray:
    """Ricker wavelet, identical to scipy.signal.ricker."""
    A = 2 / (np.sqrt(3 * a) * np.pi**0.25)
    vec = np.arange(0, points) - (points - 1.0) / 2
    xsq = vec**2
    mod = 1 - xsq / a**2
    gauss = np.exp(-xsq / (2 * a**2))
    return (A * mod * gauss).astype(np.float64)


def scale_widths(n_scales: int = N_SCALES, tau: float = TAU):
    return [2 ** (i + 1) * tau for i in range(1, n_scales + 1)]


def scale_constants(n_scales: int = N_SCALES) -> np.ndarray:
    return np.array([(i + 2.5) ** (-5 / 2) for i in range(1, n_scales + 1)])


def _ricker_rows(normed: torch.Tensor, lengths: torch.Tensor, n_scales: int = N_SCALES,
                 tau: float = TAU) -> torch.Tensor:
    """The CWT rows of ``normed`` (B, T), f32: per scale and item the Ricker
    kernel of ``pts = min(int(10 width), length)`` taps (centred at
    (pts - 1) / 2, as ``decompose_padded`` builds it inside a buffer of
    ``min(int(10 width), T)``), ``normed`` convolved with it in full and the
    'same' crop taken from ``(pts - 1) // 2``. Returns (B, T, n_scales),
    each row times its scale constant; nothing is masked."""
    B, T = normed.shape
    dev = normed.device
    widths = scale_widths(n_scales, tau)
    M = min(max(int(10 * w) for w in widths), T)
    max_pts = torch.tensor([int(10 * w) for w in widths], device=dev)
    pts = torch.minimum(max_pts[None, :], lengths[:, None].to(torch.int64))  # (B, S)
    j = torch.arange(M, device=dev, dtype=torch.float32)
    vec = j - (pts.float()[..., None] - 1.0) / 2.0                            # (B, S, M)
    xsq = vec ** 2
    col = lambda vals: torch.tensor(vals, device=dev, dtype=torch.float32)[:, None]
    w2 = col([a ** 2 for a in widths])
    amp = col([2 / (np.sqrt(3 * a) * np.pi ** 0.25) for a in widths])
    k = amp * (1 - xsq / w2) * torch.exp(-xsq / col([2 * a ** 2 for a in widths]))
    k = torch.where(j < pts[..., None], k, 0.0)
    n_fft = 1
    while n_fft < T + M - 1:
        n_fft *= 2
    full = torch.fft.irfft(torch.fft.rfft(normed.float(), n=n_fft)[:, None, :]
                           * torch.fft.rfft(k, n=n_fft), n=n_fft)             # (B, S, n_fft)
    start = torch.div(torch.clamp(pts - 1, min=0), 2, rounding_mode="floor")
    rows = full.gather(-1, start[..., None] + torch.arange(T, device=dev))    # (B, S, T)
    consts = torch.tensor(scale_constants(n_scales), device=dev, dtype=torch.float32)
    return (rows * consts[:, None]).transpose(1, 2)


def decompose_fixed_length(signal: torch.Tensor, n_scales: int = N_SCALES,
                           tau: float = TAU) -> torch.Tensor:
    """CWT spectrogram (..., T, n_scales) of signals of length T (the JAX
    package's ``decompose_fixed_length``): every kernel of ``min(10 width,
    T)`` taps."""
    T = signal.shape[-1]
    flat = signal.reshape(-1, T)
    lengths = torch.full((flat.shape[0],), T, device=signal.device)
    return _ricker_rows(flat, lengths, n_scales, tau).reshape(signal.shape + (n_scales,))


def decompose(signal: torch.Tensor) -> dict:
    """Full decomposition matching ``CWT.decompose`` (cwt.py:30-46) over the
    last axis of ``signal`` (..., T): zeros -> 1e-7, log, z-normalize (the
    population std + 1e-7), CWT; returns the log signal, the spectrogram
    (..., T, 10) and the log signal's mean and std (...)."""
    signal = torch.where(signal == 0, 1e-7, signal)
    log_sig = torch.log(signal)
    mean = log_sig.mean(-1)
    std = log_sig.std(-1, correction=0)
    normed = (log_sig - mean[..., None]) / (std[..., None] + 1e-7)
    return {"signal": log_sig, "spectrogram": decompose_fixed_length(normed),
            "mean": mean, "std": std}


def decompose_padded(signal: torch.Tensor, length: torch.Tensor, n_scales: int = N_SCALES,
                     tau: float = TAU) -> dict:
    """``decompose`` of zero-padded signals (B, T) whose true lengths are
    ``length`` (B,) (the JAX package's ``decompose_padded``): the mean and
    std over each item's own frames, each item's kernels truncated at its
    own length, every output at t >= length zero. Values below the length
    match ``decompose_np`` on the item alone (f32 and the FFT's rounding
    aside)."""
    B, T = signal.shape
    length = length.to(device=signal.device, dtype=torch.int64)
    valid = torch.arange(T, device=signal.device) < length[:, None]
    sig = torch.where(valid, signal, 1.0)
    sig = torch.where(sig == 0, 1e-7, sig)
    log_sig = torch.where(valid, torch.log(sig), 0.0)
    n = torch.clamp(length, min=1).to(signal.dtype)
    mean = log_sig.sum(-1) / n
    var = torch.where(valid, (log_sig - mean[:, None]) ** 2, 0.0).sum(-1) / n
    std = torch.sqrt(var)
    normed = torch.where(valid, (log_sig - mean[:, None]) / (std[:, None] + 1e-7), 0.0)
    spec = _ricker_rows(normed, length, n_scales, tau)
    return {"signal": log_sig, "spectrogram": torch.where(valid[..., None], spec, 0.0),
            "mean": mean, "std": std}


def decompose_np(signal: np.ndarray) -> dict:
    """Host-side (numpy) decomposition matching ``CWT.decompose``
    (cwt.py:30-46): zeros -> 1e-7, log, z-normalize (std + 1e-7), CWT."""
    signal = np.asarray(signal, dtype=np.float64).copy()
    signal[signal == 0] = 1e-7
    original = signal.copy()
    log_sig = np.log(signal)
    mean, std = log_sig.mean(), log_sig.std()
    normed = (log_sig - mean) / (std + 1e-7)
    rows = []
    for width, c in zip(scale_widths(), scale_constants()):
        points = int(min(10 * width, len(signal)))
        rows.append(np.convolve(normed, ricker(points, width), mode="same") * c)
    return {
        "signal": log_sig,
        "original_signal": original,
        "spectrogram": np.stack(rows).T,
        "mean": mean,
        "std": std,
    }


def recompose(spectrogram: torch.Tensor, mean: torch.Tensor,
              std: torch.Tensor) -> torch.Tensor:
    """spectrogram (B, T, scales), mean/std (B,) -> signal (B, T).

    Sums the scales, z-normalizes over the whole time axis, padded frames
    included, so the result depends on the static frame bucket T, as in
    the reference. The std is the population std (``correction=0``, as
    ``jnp.std``)."""
    sig = spectrogram.sum(-1)
    mu = sig.mean(-1, keepdim=True)
    sd = sig.std(-1, correction=0, keepdim=True)
    sig = (sig - mu) / (sd + 1e-7)
    return sig * std[:, None] + mean[:, None]

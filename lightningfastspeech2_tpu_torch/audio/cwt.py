"""Continuous wavelet transform of prosody signals.

Counterpart of ``lightningfastspeech2_tpu/audio/cwt.py``: the reference
decomposes log-pitch into a 10-scale Ricker ("Mexican hat") CWT
spectrogram plus mean/std, and recomposes by summing scales and
re-normalizing (reference ``litfass/dataset/cwt.py``, after Suni et al.
SSW8 2.3). Scale widths are ``2**(i+1) * tau`` for i=1..10 with
tau=0.2833425, and each scale row is weighted by ``(i + 2.5)**(-5/2)``.

``decompose_np`` (the data pipeline's, numpy) is a copy, bit for bit;
``recompose`` (the model's inverse) runs in PyTorch. The padded twins of
the JAX package (``decompose``, ``decompose_padded``) belong to on-device
feature extraction in the train step, not ported yet.
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

"""Continuous-wavelet pitch transform: the inverse only.

Counterpart of ``recompose`` in ``lightningfastspeech2_tpu/audio/cwt.py``
(the forward decomposition runs in the data pipeline, not ported yet).
"""

from __future__ import annotations

import torch


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

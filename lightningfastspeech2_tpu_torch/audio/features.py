"""Frame-level prosody features and their post-processing.

Counterpart of ``lightningfastspeech2_tpu/audio/features.py`` (the
reference's online extraction, ``litfass/dataset/datasets.py:566-648,
796-837``): ``frame_energy`` in PyTorch on the wav's device; NaN
interpolation, phone averaging, expansion, normalization and duration
augmentation as copies of the numpy helpers, bit for bit; and the on-device
twins of NaN interpolation and phone averaging (``interpolate_nans_t``,
``phone_average_t``) for ``train/on_device_features.py``.
"""

from __future__ import annotations

import numpy as np
import torch


def frame_energy(wav: torch.Tensor, hop_length: int = 256,
                 win_length: int = 1024) -> torch.Tensor:
    """Per-frame RMS energy of a wav (..., N), each row on its own.

    Frame x spans samples [x*hop, x*hop + win); the divisor is always
    ``win_length`` even for the truncated tail windows, and the number of
    frames is ceil(len/hop) (datasets.py:601-620). A cumsum difference, as
    in the JAX package."""
    n = wav.shape[-1]
    n_frames = -(-n // hop_length)
    sq = wav.to(torch.float32).square()
    csum = torch.cat([sq.new_zeros(sq.shape[:-1] + (1,)), torch.cumsum(sq, -1)], -1)
    starts = torch.clamp(torch.arange(n_frames, device=wav.device) * hop_length, max=n)
    ends = torch.clamp(starts + win_length, max=n)
    # clamp: float cumsum differences can dip microscopically below zero
    window_sums = torch.clamp(csum[..., ends] - csum[..., starts], min=0.0)
    return torch.sqrt(window_sums / win_length)


def energy_rounding_bound(wav: np.ndarray, win_length: int = 1024) -> float:
    """How far two f32 runs of ``frame_energy`` on one wav may differ when
    their prefix sums add in different orders (another device, XLA's
    cumsum): a bound B on |e_a^2 - e_b^2| of every frame. Each window sum is
    a difference of two prefix sums, each rounded at eps32 times the running
    sum; B = 16 eps32 sum(x^2) / win."""
    eps = float(np.finfo(np.float32).eps)
    return 16 * eps * float(np.sum(np.asarray(wav, np.float64) ** 2)) / win_length


def energy_error_bound(ea: np.ndarray, eb: np.ndarray, bound: float) -> np.ndarray:
    """Per frame, the most two energies within ``energy_rounding_bound``
    ``bound`` of each other's square can differ: B / (e_a + e_b), and
    sqrt(B) at a silent frame."""
    s = np.asarray(ea, np.float64) + np.asarray(eb, np.float64)
    return np.minimum(np.sqrt(bound), bound / np.maximum(s, 1e-30))


def interpolate_nans(x: np.ndarray) -> np.ndarray:
    """Linear interpolation over NaN runs (datasets.py:830-837 semantics:
    np.interp over non-NaN support; edge NaNs take the nearest valid
    value)."""
    x = np.asarray(x, dtype=np.float64).copy()
    nans = np.isnan(x)
    if nans.all() or not nans.any():
        return x
    idx = np.arange(len(x))
    x[nans] = np.interp(idx[nans], idx[~nans], x[~nans])
    return x


def interpolate_nans_t(x: torch.Tensor) -> torch.Tensor:
    """On-device NaN linear interpolation along the last axis of ``x``
    (the JAX package's ``interpolate_nans_jnp``): each NaN takes the line
    between its nearest valid neighbours (a ``cummax`` of the valid indices
    from the left, a flipped ``cummin`` from the right); NaNs outside the
    valid support take the boundary value (np.interp's clamp). A row of NaN
    only stays NaN."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    valid = ~torch.isnan(x)
    left = torch.cummax(torch.where(valid, idx, -1), -1).values
    right = torch.cummin(torch.where(valid, idx, n).flip(-1), -1).values.flip(-1)
    left_c = left.clamp(0, n - 1)
    right_c = right.clamp(0, n - 1)
    xl = x.gather(-1, left_c)
    xr = x.gather(-1, right_c)
    # the weight in f32 from the integer distances; 1 where left == right
    w = (idx - left_c).float() / (right_c - left_c).clamp(min=1).float()
    interp = xl * (1 - w) + xr * w
    interp = torch.where(left < 0, xr, interp)
    interp = torch.where(right >= n, xl, interp)
    return torch.where(valid, x, interp)


def phone_average_t(values: torch.Tensor, durations: torch.Tensor,
                    max_phones: int) -> torch.Tensor:
    """On-device phone averaging (the JAX package's ``phone_average_jnp``):
    ``values`` (..., T) frame signals, ``durations`` (..., P) frame counts
    padded with zeros -> (..., max_phones) means over each phone's frames,
    1e-7 at zero-duration slots; frames past the durations' total belong to
    no phone. Each sum is a masked f32 reduction over a (P, T) span mask, so
    it is deterministic on the card (no atomics) and adds only the phone's
    own frames, as ``segment_sum`` does."""
    d = durations[..., :max_phones].to(torch.int64)
    ends = torch.cumsum(durations.to(torch.int64), -1)[..., :max_phones]
    starts = ends - d
    t = torch.arange(values.shape[-1], device=values.device)
    span = (t >= starts[..., None]) & (t < ends[..., None])          # (..., P, T)
    sums = torch.where(span, values[..., None, :], 0.0).sum(-1)
    means = sums / d.clamp(min=1).to(values.dtype)
    return torch.where(d > 0, means, torch.full_like(means, 1e-7))


def phone_average(values: np.ndarray, durations: np.ndarray) -> np.ndarray:
    """Average a frame-level signal over each phone's duration span
    (datasets.py:632-640). Zero-duration phones get 1e-7."""
    out = np.empty(len(durations), dtype=np.float64)
    pos = 0
    for j, d in enumerate(durations):
        d = int(d)
        if d > 0:
            out[j] = np.mean(values[pos : pos + d])
        else:
            out[j] = 1e-7
        pos += d
    return out


def expand_by_duration(values: np.ndarray, durations: np.ndarray) -> np.ndarray:
    """Repeat each phone value duration times (TTSDataset._expand,
    datasets.py:818-828)."""
    return np.repeat(np.asarray(values), np.maximum(durations, 0).astype(int))


def znormalize(x, mean: float, std: float):
    return (x - mean) / std


def denormalize(x, mean: float, std: float):
    return x * std + mean


def augment_durations(
    durations: np.ndarray, rng: np.random.Generator, augment_fraction: float
) -> np.ndarray:
    """Random duration jitter preserving the total (datasets.py:796-816):
    a random subset of phones gets +-N(0,1) rounded jitter, compensated on
    the same subset to keep sum(durations) constant, then clipped >= 0."""
    durations = np.asarray(durations).copy()
    if augment_fraction <= 0:
        return durations
    n = len(durations)
    k = int(np.round(n * augment_fraction))
    if k == 0:
        return durations
    idx = rng.choice(n, size=k, replace=False)
    jitter = np.round(rng.normal(0, 1, size=k)).astype(durations.dtype)
    total_before = durations.sum()
    durations[idx] += jitter
    durations = np.clip(durations, 0, None)
    # compensate to preserve total duration
    diff = durations.sum() - total_before
    i = 0
    while diff != 0 and i < 10 * n:
        j = idx[i % k]
        step = -np.sign(diff)
        if durations[j] + step >= 0:
            durations[j] += step
            diff += step
        i += 1
    return durations

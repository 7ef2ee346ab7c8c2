"""Speech-to-Reverberation Modulation energy Ratio (SRMR).

Counterpart of ``lightningfastspeech2_tpu/audio/srmr.py``, a from-scratch
implementation of the published algorithm (Falk, Zheng & Chan 2010) in place
of the reference's numba SRMRpy fork (reference
``litfass/dataset/datasets.py:119,622-628``):

1. a 23-channel gammatone filterbank, ERB-spaced from 125 Hz,
2. temporal envelopes by the Hilbert transform,
3. a modulation spectrogram: 256 ms Hamming windows at a 64 ms hop, energy
   summed in 8 modulation bands around the standard centres (4..128 Hz,
   Q = 2),
4. SRMR = the energy of bands 1-4 over that of bands 5-8, per window.

The filterbank, the envelopes and the modulation spectra are ``torch.fft``
in f32 on the caller's device (the dataset's, as the rest of the front end),
for a wav (N,) or a batch (..., N), each row on its own; the per-window
ratios are interpolated onto the mel frame grid on the host like the
reference (``datasets.py:622-628``, ``frame_srmr``), or on the device for a
padded batch (``frame_srmr_padded``, the on-device features' twin).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lightningfastspeech2_tpu_torch.core.device import DeviceLike, resolve_device

MOD_CENTERS = np.array([4.0, 6.5, 10.7, 17.6, 28.9, 47.5, 78.1, 128.0])
N_GAMMATONE = 23
GT_LOW = 125.0


def erb_space(low: float, high: float, n: int) -> np.ndarray:
    """ERB-rate-spaced center frequencies (Glasberg & Moore)."""
    ear_q, min_bw = 9.26449, 24.7
    lo = np.log(low + ear_q * min_bw)
    hi = np.log(high + ear_q * min_bw)
    return np.exp(np.linspace(lo, hi, n)) - ear_q * min_bw


@functools.lru_cache(maxsize=4)
def gammatone_fir(sampling_rate: int, n_taps: int = 512) -> np.ndarray:
    """(n_channels, n_taps) 4th-order gammatone impulse responses, each of
    unit energy."""
    high = min(sampling_rate / 2 * 0.9, 8000.0)
    cfs = erb_space(GT_LOW, high, N_GAMMATONE)
    t = np.arange(n_taps) / sampling_rate
    firs = []
    for cf in cfs:
        erb = 24.7 * (4.37 * cf / 1000 + 1)
        b = 1.019 * erb
        ir = t ** 3 * np.exp(-2 * np.pi * b * t) * np.cos(2 * np.pi * cf * t)
        ir /= max(np.sqrt(np.sum(ir ** 2)), 1e-30)
        firs.append(ir)
    return np.stack(firs).astype(np.float32)


def _fft_filterbank(wav: torch.Tensor, firs: torch.Tensor) -> torch.Tensor:
    """Convolve wav (..., N) with each FIR -> (..., C, N) through the FFT."""
    N, K = wav.shape[-1], firs.shape[-1]
    n_fft = 1
    while n_fft < N + K:
        n_fft *= 2
    W = torch.fft.rfft(wav, n=n_fft)
    F = torch.fft.rfft(firs, n=n_fft, dim=-1)
    return torch.fft.irfft(F * W[..., None, :], n=n_fft, dim=-1)[..., :N]


def _envelope(x: torch.Tensor) -> torch.Tensor:
    """|analytic signal| of each row through the Hilbert transform."""
    N = x.shape[-1]
    h = torch.zeros(N, device=x.device)
    if N % 2 == 0:
        h[0] = h[N // 2] = 1
        h[1:N // 2] = 2
    else:
        h[0] = 1
        h[1:(N + 1) // 2] = 2
    return torch.abs(torch.fft.ifft(torch.fft.fft(x, dim=-1) * h, dim=-1))


@functools.lru_cache(maxsize=8)
def _band_masks(win: int, sampling_rate: int) -> np.ndarray:
    """(F, 8) f32: each modulation band's Q = 2 mask over the rfft bins."""
    freqs = np.fft.rfftfreq(win, 1.0 / sampling_rate)
    return np.stack([((freqs >= cf - cf / 4) & (freqs <= cf + cf / 4)).astype(np.float32)
                     for cf in MOD_CENTERS], -1)


def srmr_per_window(wav, sampling_rate: int = 22050, window_s: float = 0.256,
                    hop_s: float = 0.064, device: DeviceLike = None) -> torch.Tensor:
    """Per-window SRMR values of a wav (..., N), (..., n_windows) f32 on
    ``device`` (``wav``'s where it is a tensor, else ``cuda`` unless the
    caller asks for the CPU)."""
    if device is None and torch.is_tensor(wav):
        device = wav.device
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(wav, np.float32) if not torch.is_tensor(wav) else wav,
                        dtype=torch.float32, device=dev)
    firs = torch.from_numpy(gammatone_fir(sampling_rate)).to(dev)
    env = _envelope(_fft_filterbank(x, firs))                     # (..., C, N)

    win, hop = int(window_s * sampling_rate), int(hop_s * sampling_rate)
    N = env.shape[-1]
    n_windows = max(1 + (N - win) // hop, 1)
    idx = (torch.arange(n_windows, device=dev)[:, None] * hop
           + torch.arange(win, device=dev)[None, :]).clamp(max=N - 1)
    frames = env[..., idx]                                          # (..., C, W, win)
    hamming = torch.from_numpy(np.hamming(win).astype(np.float32)).to(dev)
    frames = (frames - frames.mean(-1, keepdim=True)) * hamming
    spec = torch.abs(torch.fft.rfft(frames, dim=-1)) ** 2           # (..., C, W, F)
    masks = torch.from_numpy(_band_masks(win, sampling_rate)).to(dev)
    be = torch.stack([(spec * masks[:, j]).sum(-1) for j in range(masks.shape[1])], -1)
    low = be[..., :4].sum((-3, -1))
    high = be[..., 4:].sum((-3, -1))
    return low / torch.clamp(high, min=1e-8)


def frame_srmr_padded(wav: torch.Tensor, length: torch.Tensor, n_frames: torch.Tensor,
                      max_frames: int, sampling_rate: int = 22050, window_s: float = 0.256,
                      hop_s: float = 0.064) -> torch.Tensor:
    """Static-shape twin of ``frame_srmr`` for the on-device features (the
    JAX package's ``frame_srmr_padded``), on ``wav``'s device: ``wav`` a
    zero-padded batch (B, N_max), ``length`` (B,) each item's sample count,
    ``n_frames`` (B,) its mel frames; returns (B, max_frames) with the
    interpolated SRMR on each item's first ``n_frames`` positions.

    As in the JAX package, the Hilbert envelope is taken over the padded
    buffer, not the item's own length (the analytic-signal kernel decays
    like 1/t, so in-signal windows move by under 1e-3 relative); windows
    past an item's length never enter its interpolation, and an item of one
    window is constant (np.repeat on the host)."""
    values = srmr_per_window(wav, sampling_rate, window_s, hop_s)   # (B, W_max)
    win, hop = int(window_s * sampling_rate), int(hop_s * sampling_rate)
    length = length.to(device=values.device, dtype=torch.int64)
    n_frames = n_frames.to(device=values.device, dtype=torch.int64)
    n_valid = torch.clamp(1 + torch.div(length - win, hop, rounding_mode="floor"), min=1)
    w_max = values.shape[-1]
    # linear interpolation of each item's valid prefix onto its frame
    # prefix (datasets.py:622-628), in static shapes
    j = torch.arange(max_frames, device=values.device, dtype=torch.float32)
    denom = torch.clamp(n_frames.float() - 1.0, min=1.0)
    pos = j / denom[:, None] * (n_valid.float()[:, None] - 1.0)
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, w_max - 1)
    hi = torch.clamp(lo + 1, 0, w_max - 1)
    # clamped into the valid prefix, so padding windows never leak in
    lo = torch.minimum(lo, n_valid[:, None] - 1)
    hi = torch.minimum(hi, n_valid[:, None] - 1)
    frac = torch.clamp(pos - lo.float(), 0.0, 1.0)
    out = values.gather(-1, lo) * (1.0 - frac) + values.gather(-1, hi) * frac
    return torch.where(n_valid[:, None] > 1, out, values[:, :1])


def frame_srmr(wav: np.ndarray, n_frames: int, sampling_rate: int = 22050,
               device: DeviceLike = None) -> np.ndarray:
    """SRMR interpolated onto the mel frame grid (datasets.py:622-628: one
    window -> constant, else linear over [0, 1]), float64 numpy."""
    with torch.no_grad():
        values = srmr_per_window(wav, sampling_rate, device=device).cpu().numpy()
    if len(values) == 1:
        return np.repeat(values, n_frames)
    src = np.linspace(0, 1, len(values))
    dst = np.linspace(0, 1, n_frames)
    return np.interp(dst, src, values)

"""Post-vocoder audio restoration to 44.1 kHz (the VoiceFixer slot).

Counterpart of ``lightningfastspeech2_tpu/synthesis/restore.py``, in torch on
the restorer's device (the generator's: the card unless ``"cpu"``):

1. ``declip``: rail-limited flat runs rebuilt by cubic Hermite
   interpolation from the samples and slopes around them;
2. ``neural_denoise`` (the learned mask of ``synthesis/denoiser.py``, the
   default when its weights exist) or ``spectral_denoise`` (power
   subtraction under a noise floor from the quietest valid frames);
3. ``upsample_2x``: exact band-limited 2x upsampling by rfft zero-padding
   (``torch.fft`` takes the odd sizes that kept the JAX package on the
   host here);
4. ``band_replicate``: the empty top octave filled from the octave below.

``AudioRestorer`` pads 0.1 s each side, pads to a multiple of
``bucket_step`` samples, restores, and removes the pad at the output rate.
The STFTs and FFTs are ``torch.fft`` calls; no kernel of this package runs
here.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from lightningfastspeech2_tpu_torch.core.device import DeviceLike, resolve_device
from lightningfastspeech2_tpu_torch.synthesis import denoiser as dn

_N_FFT = 1024
_HOP = 256


def _hann(n_fft: int, device) -> torch.Tensor:
    return torch.as_tensor(np.hanning(n_fft + 1)[:-1].astype(np.float32), device=device)


def stft(x: torch.Tensor, n_fft: int = _N_FFT, hop: int = _HOP) -> torch.Tensor:
    """Center-padded (constant) complex STFT, frames on axis 0: (T, F)."""
    pad = n_fft // 2
    frames = torch.nn.functional.pad(x, (pad, pad)).unfold(0, n_fft, hop)
    return torch.fft.rfft(frames * _hann(n_fft, x.device), dim=-1)


def istft(spec: torch.Tensor, length: int, n_fft: int = _N_FFT,
          hop: int = _HOP) -> torch.Tensor:
    """Overlap-add inverse with squared-window normalization."""
    win = _hann(n_fft, spec.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * win
    n_frames = spec.shape[0]
    out_len = n_fft + (n_frames - 1) * hop
    pos = (torch.arange(n_frames, device=spec.device)[:, None] * hop
           + torch.arange(n_fft, device=spec.device)[None, :]).reshape(-1)
    out = torch.zeros(out_len, dtype=frames.dtype, device=spec.device)
    out.index_add_(0, pos, frames.reshape(-1))
    wsum = torch.zeros_like(out).index_add_(0, pos, (win * win).repeat(n_frames))
    out = out / torch.clamp(wsum, min=1e-8)
    pad = n_fft // 2
    return out[pad:pad + length]


def declip(x: torch.Tensor, threshold: float = 0.985) -> torch.Tensor:
    """Rebuild rail-limited runs by cubic Hermite interpolation: samples at
    >= ``threshold`` of the peak that are flat against a neighbour count as
    clipped; each run becomes the Hermite cubic through the nearest valid
    samples on either side with their one-sample slopes."""
    n = x.shape[0]
    idx = torch.arange(n, device=x.device)
    peak = x.abs().max()
    at_rail = x.abs() >= threshold * peak
    flat_eps = 1e-3 * torch.clamp(peak, min=1e-9)
    flat = ((x - torch.roll(x, 1)).abs() < flat_eps) | ((x - torch.roll(x, -1)).abs() < flat_eps)
    clipped = at_rail & flat
    valid = ~clipped
    left = torch.cummax(torch.where(valid, idx, -1), 0).values
    right = torch.cummin(torch.where(valid, idx, n).flip(0), 0).values.flip(0)
    interior = (left >= 0) & (right < n)
    l = left.clamp(0, n - 1)
    r = right.clamp(0, n - 1)
    p0, p1 = x[l], x[r]
    m0 = p0 - x[(l - 1).clamp(0, n - 1)]
    m1 = x[(r + 1).clamp(0, n - 1)] - p1
    span = (r - l).to(x.dtype)
    t = torch.where(span > 0, (idx - l).to(x.dtype) / torch.clamp(span, min=1), 0.0)
    t2, t3 = t * t, t * t * t
    y = ((2 * t3 - 3 * t2 + 1) * p0 + (t3 - 2 * t2 + t) * span * m0
         + (-2 * t3 + 3 * t2) * p1 + (t3 - t2) * span * m1)
    return torch.where(clipped & interior, y, x)


def _frame_valid(n_frames: int, length, device) -> torch.Tensor:
    return torch.arange(n_frames, device=device) * _HOP < length


def spectral_denoise(x: torch.Tensor, length, strength: float = 3.0,
                     floor: float = 0.03) -> torch.Tensor:
    """Power spectral subtraction with a per-bin noise floor: the 10th
    percentile of the valid frames' magnitudes, capped at 6x the median
    over bins (so a held tone keeps its bin)."""
    spec = stft(x)
    mag = spec.abs()
    valid = _frame_valid(spec.shape[0], length, x.device)
    masked = torch.where(valid[:, None], mag, torch.nan)
    noise = torch.nanquantile(masked, 0.10, dim=0)
    # jnp.nanmedian interpolates as nanquantile(0.5) does
    noise = torch.minimum(noise, 6.0 * torch.nanquantile(noise, 0.5))
    g2 = 1.0 - (strength * noise / torch.clamp(mag, min=1e-8)) ** 2
    gain = torch.sqrt(torch.clamp(g2, floor ** 2, 1.0))
    gain = (torch.roll(gain, 1, 0) + gain + torch.roll(gain, -1, 0)) / 3.0
    return istft(spec * gain, x.shape[0])


def upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Exact band-limited 2x upsampling via rfft zero-padding."""
    n = x.shape[0]
    X = torch.fft.rfft(x)
    Y = torch.zeros(n + 1, dtype=X.dtype, device=x.device)
    Y[: X.shape[0]] = X
    return torch.fft.irfft(Y, n=2 * n) * 2.0


def band_replicate(x: torch.Tensor, gains: tuple = (0.5, 0.22)) -> torch.Tensor:
    """Fill the empty top octave after 2x upsampling: the quarter-to-half
    Nyquist band shifted up twice with decaying gain, donor phase kept."""
    spec = stft(x)
    q = (spec.shape[1] - 1) // 4
    donor = spec[:, q: 2 * q]
    out = spec.clone()
    out[:, 2 * q: 3 * q] += donor * gains[0]
    out[:, 3 * q: 4 * q] += donor * gains[1]
    return istft(out, x.shape[0])


def neural_denoise(x: torch.Tensor, net: dn.MaskNet, length=None) -> torch.Tensor:
    """Learned-mask denoise: masks the magnitude, keeps the phase;
    ``length`` (valid samples of a bucket-padded x) keeps the mask net's
    normalization on the real frames."""
    spec = stft(x)
    mag = spec.abs()
    valid = None if length is None else _frame_valid(mag.shape[0], length, x.device)
    masked = dn.apply_mask_net(net, mag, frame_valid=valid)
    phase = spec / torch.clamp(mag, min=1e-8)
    return istft(phase * masked, x.shape[0])


@torch.no_grad()
def restore_padded(x: torch.Tensor, length: int, strength: float, threshold: float,
                   sbr: bool, net: Optional[dn.MaskNet] = None) -> torch.Tensor:
    y = declip(x, threshold)
    if net is not None:
        y = neural_denoise(y, net, length=length)
    else:
        y = spectral_denoise(y, length, strength=strength)
    y = upsample_2x(y)
    if sbr:
        y = band_replicate(y)
    return y


class AudioRestorer:
    """Serving-contract wrapper: ``restorer(wav, sr) -> wav @ 44.1 kHz`` on
    ``device`` (``cuda`` unless ``"cpu"``). ``denoiser``: "neural" (the
    learned mask, ``data/denoiser.npz``), "spectral" (the DSP gate), "auto"
    (neural when the weights exist, else spectral, with a warning)."""

    input_sampling_rate = 22050
    output_sampling_rate = 44100

    def __init__(self, denoise_strength: float = 3.0, declip_threshold: float = 0.985,
                 sbr: bool = True, pad_seconds: float = 0.1, bucket_step: int = 16384,
                 denoiser: str = "auto", device: DeviceLike = None):
        self.device = resolve_device(device)
        self.denoise_strength = float(denoise_strength)
        self.declip_threshold = float(declip_threshold)
        self.sbr = bool(sbr)
        self.pad_seconds = float(pad_seconds)
        self.bucket_step = int(bucket_step)
        self.net = None
        if denoiser in ("auto", "neural"):
            self.net = dn.load(device=self.device)
            if self.net is None:
                if denoiser == "neural":
                    raise FileNotFoundError(f"no denoiser weights at {dn.BUILTIN_PATH}")
                logging.getLogger(__name__).warning(
                    "denoiser='auto': no weights at %s; falling back to the "
                    "spectral gate", dn.BUILTIN_PATH)

    def __call__(self, wav: np.ndarray, sr: int) -> np.ndarray:
        wav = np.asarray(wav, np.float32)
        if sr != self.input_sampling_rate:
            n_out = int(round(len(wav) * self.input_sampling_rate / sr))
            t_in = np.arange(len(wav)) / sr
            t_out = np.arange(n_out) / self.input_sampling_rate
            wav = np.interp(t_out, t_in, wav).astype(np.float32)
            sr = self.input_sampling_rate
        pad = int(sr * self.pad_seconds)
        padded = np.pad(wav, (pad, pad))
        bucket = max(self.bucket_step,
                     int(np.ceil(len(padded) / self.bucket_step)) * self.bucket_step)
        buf = np.zeros(bucket, np.float32)
        buf[: len(padded)] = padded
        out = restore_padded(torch.as_tensor(buf, device=self.device), len(padded),
                             self.denoise_strength, self.declip_threshold, self.sbr,
                             self.net).cpu().numpy().astype(np.float32)
        # the pad comes off at the output rate
        start = 2 * pad
        return out[start: start + 2 * len(wav)]

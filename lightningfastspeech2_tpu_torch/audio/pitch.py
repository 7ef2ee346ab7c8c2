"""Fundamental-frequency (F0) estimation in PyTorch: a batched, FFT-based
YIN tracker (de Cheveigne & Kawahara 2002) on the mel frame grid.

Counterpart of ``lightningfastspeech2_tpu/audio/pitch.py`` (which replaces
the reference's pyworld DIO + StoneMask, ``litfass/dataset/datasets.py:
566-582``, on the same frame grid). The same math on the wav's device,
with ``torch.fft.rfft`` / ``irfft`` at the same power-of-two length. Every
function takes leading batch dims: a wav (..., N) gives frames (..., T,
W + tau_max) and a track (..., T), each row on its own.

YIN's decisions are discontinuous: the absolute threshold, the
local-minimum test, the first candidate or the global minimum, and the
voicing cut. A frame whose d' sits within rounding of one of them can choose
another lag on another FFT implementation (``near_decision`` finds such
frames).
"""

from __future__ import annotations

import torch

F0_FLOOR = 71.0   # pyworld default
F0_CEIL = 800.0   # pyworld default
YIN_THRESHOLD = 0.15


def lag_range(sampling_rate: int, f0_floor: float = F0_FLOOR,
              f0_ceil: float = F0_CEIL):
    """(tau_min, tau_max) of the lag search."""
    return max(int(sampling_rate / f0_ceil), 2), int(sampling_rate / f0_floor) + 1


def _difference_function(frames: torch.Tensor, tau_max: int) -> torch.Tensor:
    """YIN difference d(tau) for all frames at once via FFT correlation.

    frames: (..., T, W + tau_max) windows. Returns (..., T, tau_max + 1).
    d(tau) = sum_{j<W} (x[j] - x[j+tau])^2
           = e0 + e_tau - 2 * sum_j x[j] x[j+tau]
    """
    L = frames.shape[-1]
    W = L - tau_max
    sq = frames.square()
    csum = torch.cat([frames.new_zeros(frames.shape[:-1] + (1,)), torch.cumsum(sq, -1)], -1)
    e0 = csum[..., W] - csum[..., 0]                   # (..., T)
    taus = torch.arange(tau_max + 1, device=frames.device)
    e_tau = csum[..., W + taus] - csum[..., taus]      # (..., T, tau_max+1)

    # cross-correlation of x[0:W] with the full window, lags 0..tau_max
    n_fft = 1
    while n_fft < L + W:
        n_fft *= 2
    head = torch.where(torch.arange(L, device=frames.device) < W, frames, 0.0)
    F_head = torch.fft.rfft(head, n=n_fft, dim=-1)
    F_full = torch.fft.rfft(frames, n=n_fft, dim=-1)
    corr = torch.fft.irfft(torch.conj(F_head) * F_full, n=n_fft, dim=-1)
    cross = corr[..., : tau_max + 1]

    return e0[..., None] + e_tau - 2.0 * cross


def _cmnd(d: torch.Tensor) -> torch.Tensor:
    """Cumulative mean normalized difference d'(tau); d'(0) = 1."""
    taus = torch.arange(1, d.shape[-1], device=d.device)
    cum = torch.cumsum(d[..., 1:], -1)
    dprime = d[..., 1:] * taus / torch.clamp(cum, min=1e-12)
    return torch.cat([d.new_ones(d.shape[:-1] + (1,)), dprime], -1)


def _lag_candidates(dp: torch.Tensor, tau_min: int, tau_max: int, threshold: float):
    """d' limited to the lag range (inf outside), and the lags that dip
    under the threshold at a local minimum."""
    taus = torch.arange(dp.shape[-1], device=dp.device)
    in_range = (taus >= tau_min) & (taus < tau_max)
    dpr = torch.where(in_range, dp, torch.inf)
    below = dpr < threshold
    inner = (dpr[..., 1:-1] <= dpr[..., :-2]) & (dpr[..., 1:-1] <= dpr[..., 2:])
    is_min = torch.nn.functional.pad(inner, (1, 1), value=False)
    return dpr, below & is_min


def _yin(frames: torch.Tensor, sampling_rate: int, f0_floor: float, f0_ceil: float,
         threshold: float) -> dict:
    """YIN's steps on (..., T, W + tau_max) windows: d', the lag-range d' and
    candidates, the chosen lag, its parabolic refinement, the F0 before the
    range cut and the voicing."""
    tau_min, tau_max = lag_range(sampling_rate, f0_floor, f0_ceil)
    d = _difference_function(frames, tau_max)
    dp = _cmnd(d)  # (..., T, tau_max+1)

    # absolute-threshold rule: first tau whose d' dips under threshold and
    # is a local minimum; fall back to the global minimum
    dpr, candidate = _lag_candidates(dp, tau_min, tau_max, threshold)
    first_idx = torch.argmax(candidate.to(torch.uint8), -1)
    has_candidate = candidate.any(-1)
    argmin_idx = torch.argmin(dpr, -1)
    tau_star = torch.where(has_candidate, first_idx, argmin_idx)

    # parabolic interpolation around tau_star
    t = torch.clamp(tau_star, 1, dp.shape[-1] - 2)
    y0, y1, y2 = (dp.gather(-1, (t + o)[..., None])[..., 0] for o in (-1, 0, 1))
    denom = y0 - 2 * y1 + y2
    safe = torch.abs(denom) > 1e-12
    offset = torch.where(safe, 0.5 * (y0 - y2) / torch.where(safe, denom, 1.0), 0.0)
    offset = torch.clamp(offset, -0.5, 0.5)
    tau_refined = t + offset

    return dict(dp=dp, dpr=dpr, candidate=candidate, has_candidate=has_candidate,
                first=first_idx, best=argmin_idx, at=y1,
                f0=sampling_rate / torch.clamp(tau_refined, min=1.0))


def yin_frame_f0(
    frames: torch.Tensor,
    sampling_rate: int,
    f0_floor: float = F0_FLOOR,
    f0_ceil: float = F0_CEIL,
    threshold: float = YIN_THRESHOLD,
) -> torch.Tensor:
    """F0 per frame; 0.0 where unvoiced. frames: (..., T, W + tau_max)."""
    y = _yin(frames, sampling_rate, f0_floor, f0_ceil, threshold)
    f0 = y["f0"]
    voiced = y["at"] < max(threshold * 2.0, 0.3)
    f0 = torch.where(voiced & (f0 >= f0_floor) & (f0 <= f0_ceil), f0, 0.0)
    return f0.to(torch.float32)


def frame_windows(wav: torch.Tensor, sampling_rate: int = 22050, hop_length: int = 256,
                  win_length: int = 1024, f0_floor: float = F0_FLOOR) -> torch.Tensor:
    """The (..., 1 + N//hop, win + tau_max) YIN windows of a wav (..., N):
    frame t spans [t*hop - win/2, t*hop + win/2 + tau_max), zero-padded,
    centered like the STFT frames so that pitch, energy and mel share a time
    base."""
    n = wav.shape[-1]
    tau_max = int(sampling_rate / f0_floor) + 1
    span = win_length + tau_max
    padded = torch.nn.functional.pad(wav.to(torch.float32), (win_length // 2, span))
    return padded.unfold(-1, span, hop_length)[..., : 1 + n // hop_length, :]


def track(
    wav: torch.Tensor,
    sampling_rate: int = 22050,
    hop_length: int = 256,
    win_length: int = 1024,
    f0_floor: float = F0_FLOOR,
    f0_ceil: float = F0_CEIL,
) -> torch.Tensor:
    """F0 track on the mel frame grid: (..., 1 + N//hop) with 0 = unvoiced."""
    frames = frame_windows(wav, sampling_rate, hop_length, win_length, f0_floor)
    return yin_frame_f0(frames, sampling_rate, f0_floor, f0_ceil)


def near_decision(
    frames: torch.Tensor,
    sampling_rate: int,
    margin: float,
    f0_floor: float = F0_FLOOR,
    f0_ceil: float = F0_CEIL,
    threshold: float = YIN_THRESHOLD,
) -> torch.Tensor:
    """(..., T) bool: the frames whose F0 a change of d' by less than ``margin``
    could change by more than a lag's refinement, because a decision of
    ``yin_frame_f0`` sits within ``margin`` of its boundary: a local minimum
    (to within ``margin``) at the threshold, at or before the first
    candidate; a global minimum (without a candidate) with a rival more than
    one lag away; the voicing cut; or an F0 within ``margin`` (relative) of
    the floor or the ceiling. A flip between two adjacent lags at one dip
    moves the parabolic refinement by rounding only, and is not counted.
    Frames of exact zeros decide on exact ties, the same on every FFT, and
    are not near a decision."""
    y = _yin(frames, sampling_rate, f0_floor, f0_ceil, threshold)
    dpr, has_candidate = y["dpr"], y["has_candidate"]
    n = dpr.shape[-1]
    lags = torch.arange(n, device=dpr.device)
    inner = ((dpr[..., 1:-1] <= dpr[..., :-2] + margin)
             & (dpr[..., 1:-1] <= dpr[..., 2:] + margin))
    loose_min = torch.nn.functional.pad(inner, (1, 1), value=False)
    first = torch.where(has_candidate, y["first"], n)
    shaky = (loose_min & ((dpr - threshold).abs() < margin)
             & (lags <= first[..., None] + 1)).any(-1)

    lo = dpr.gather(-1, y["best"][..., None])
    rival = (dpr < lo + margin) & ((lags - y["best"][..., None]).abs() > 1)
    shaky |= ~has_candidate & rival.any(-1)

    shaky |= (y["at"] - max(threshold * 2.0, 0.3)).abs() < margin
    f0 = y["f0"]
    shaky |= torch.minimum((f0 / f0_floor - 1).abs(), (f0 / f0_ceil - 1).abs()) < margin
    return shaky & (frames != 0).any(-1)

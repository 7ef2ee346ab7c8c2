"""WADA blind SNR estimation (Kim & Stern 2008), vectorized.

Counterpart of ``lightningfastspeech2_tpu/audio/snr.py``, which replaces the
reference's per-window Python loop (``litfass/dataset/snr.py:260-271,
328-371``) with cumulative sums over the mel/energy frame grid. The
estimate is the table-interpolated value of the statistic
``v3 = ln(mean|x|) - mean(ln|x|)``; the g-table (``data/wada_g.npy``) is a
copy of the JAX package's, derived there by deterministic quadrature.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np
import torch

_DB_MIN, _DB_MAX = -20.0, 100.0
_EPS = 1e-20


@functools.lru_cache(maxsize=1)
def g_table() -> np.ndarray:
    path = pathlib.Path(__file__).resolve().parent.parent / "data" / "wada_g.npy"
    return np.load(path)


@functools.lru_cache(maxsize=8)
def _table(device: str) -> torch.Tensor:
    """The g-table as f32 on ``device``, built on first use in each process."""
    return torch.from_numpy(g_table().astype(np.float32)).to(device)


def wada_statistic(abs_wav: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """v3 = ln(mean|x|) - mean(ln|x|) over ``valid`` samples."""
    n = torch.clamp(valid.sum(), min=1)
    clipped = torch.clamp(abs_wav, min=_EPS)
    v1 = torch.clamp(torch.where(valid, clipped, 0.0).sum() / n, min=_EPS)
    v2 = torch.where(valid, torch.log(clipped), 0.0).sum() / n
    return torch.log(v1) - v2


def snr_from_statistic(v3: torch.Tensor) -> torch.Tensor:
    """Inverse table lookup: statistic -> SNR dB, clamped to [-20, 100].

    Reference semantics (snr.py:352-364): the largest index with
    g[idx] < v3, linearly interpolated to the next entry; below the table
    -> -20 dB, at/above the end -> 100 dB.
    """
    table = _table(str(v3.device))
    idx = torch.searchsorted(table, v3.contiguous(), right=True) - 1
    idx = torch.clamp(idx, 0, table.shape[0] - 2)
    frac = (v3 - table[idx]) / (table[idx + 1] - table[idx])
    snr = _DB_MIN + idx + frac  # db grid is 1 dB spaced from -20
    snr = torch.where(v3 <= table[0], _DB_MIN, snr)
    snr = torch.where(v3 >= table[-1], _DB_MAX, snr)
    return torch.clamp(snr, _DB_MIN, _DB_MAX)


def snr_rounding_bound(wav: np.ndarray, values: np.ndarray,
                       win_length: int = 1024) -> float:
    """How far two f32 runs of ``windowed_wada`` on one wav may differ, in
    dB, at outputs spanning ``values`` (SNR + 20, as it returns them) when
    their prefix sums add in different orders: the statistic v3 within
    16 eps32 sum|ln|x|| / win, turned into dB by the steepest g-table step
    of that span, 1 / (g[i+1] - g[i]) (step i covers outputs [i, i + 1))."""
    eps = float(np.finfo(np.float32).eps)
    logs = np.log(np.maximum(np.abs(np.asarray(wav, np.float64)), _EPS))
    v3_tol = 16 * eps * np.abs(logs).sum() / win_length + 1e-6
    g = g_table()
    lo = int(np.clip(np.floor(np.nanmin(values)) - 1, 0, len(g) - 2))
    hi = int(np.clip(np.floor(np.nanmax(values)) + 1, 0, len(g) - 2))
    return float(v3_tol * (1.0 / np.diff(g)[lo: hi + 1]).max())


def windowed_wada(
    wav: torch.Tensor,
    hop_length: int = 256,
    win_length: int = 1024,
) -> torch.Tensor:
    """Per-frame WADA SNR of a wav (..., N), each row on its own, frame grid
    [k*hop, k*hop+win) with tail truncation; frames = ceil(N/hop). Returns
    SNR+20 with NaN where the estimate leaves (-20, 100) (snr.py:260-271)."""
    n = wav.shape[-1]
    n_frames = -(-n // hop_length)
    abs_wav = torch.clamp(wav.to(torch.float32).abs(), min=_EPS)
    log_abs = torch.log(abs_wav)

    zero = abs_wav.new_zeros(abs_wav.shape[:-1] + (1,))
    csum_abs = torch.cat([zero, torch.cumsum(abs_wav, -1)], -1)
    csum_log = torch.cat([zero, torch.cumsum(log_abs, -1)], -1)

    starts = torch.clamp(torch.arange(n_frames, device=wav.device) * hop_length, max=n)
    ends = torch.clamp(starts + win_length, max=n)
    counts = torch.clamp(ends - starts, min=1)

    v1 = torch.clamp((csum_abs[..., ends] - csum_abs[..., starts]) / counts, min=_EPS)
    v2 = (csum_log[..., ends] - csum_log[..., starts]) / counts
    v3 = torch.log(v1) - v2

    snr = snr_from_statistic(v3)
    # keep strictly inside the open interval, offset +20; else NaN
    inside = (snr > _DB_MIN) & (snr < _DB_MAX)
    return torch.where(inside, snr + 20.0, torch.nan)
